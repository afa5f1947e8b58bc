"""Coarse-to-fine point registration model (GeoTransformer class), as
PyTorch modules batched over pairs.

Counterpart of ``sgaligner_tpu/reg/geo_model.py``. Every module takes a
leading pair axis ``B`` (the JAX package vmaps its single-pair modules over
it): static shapes, masked superpoints and patch points.

* ``PatchEncoder``: a shared MLP over each superpoint patch's rotation-
  invariant point features (``reg/learned.py::patch_invariants``) and a
  masked max-pool, concatenated with the patch's eigen-spectrum.
* ``GeometricStructure``: the pairwise embedding r_ij, sinusoidal distance
  plus the max over each point's ``angle_k`` nearest neighbours of the
  sinusoidal triplet angle.
* ``GeoSelfAttention``: multi-head attention whose logits carry the
  geometric term, e_ij = q_i·(k_j + r_ij) / sqrt(dh); ``CrossAttention``
  without it. Both post-norm, with a ReLU feed-forward of width 2·dim.
* ``GeoRegModel``: the encoder, ``blocks`` (self, cross) pairs, a shared
  head, log-domain Sinkhorn with a learned dustbin over the superpoints,
  and the fine head's per-point features; ``fine_log_assign`` runs the
  point-level Sinkhorn inside the matched patch pairs.

Submodule and parameter names are the flax tree's (``Dense_0``,
``LayerNorm_0``, ``q``, ``proj_d``, ...), so
``core/checkpoint.py::geo_state_dict_from_flax`` maps a tree onto
``GeoRegModel.state_dict()`` key for key. The LayerNorms use flax's
epsilon, 1e-6.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

NEG = -1e9


@dataclass(frozen=True)
class GeoModelConfig:
    dim: int = 128            # transformer width
    point_dim: int = 64       # per-point patch feature width
    heads: int = 4
    blocks: int = 3           # (geo-self, cross) repetitions
    angle_k: int = 3          # neighbours for the triplet-angle embedding
    sigma_d: float = 0.2      # distance embedding scale (metres)
    sinkhorn_iters: int = 20


def sinusoidal_embedding(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``[...] -> [..., dim]`` sinusoidal features of a continuous scalar."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=x.dtype, device=x.device) / half
                      * math.log(10000.0))
    ang = x[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinkhorn_log(scores: torch.Tensor, src_mask: torch.Tensor,
                 ref_mask: torch.Tensor, alpha: torch.Tensor | float,
                 iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn with a dustbin row and column (SuperGlue style),
    batched: ``scores [..., S, R]``, masks ``[..., S]`` / ``[..., R]``,
    ``alpha`` the dustbin logit (a scalar). Returns the log assignment
    ``[..., S+1, R+1]``; a masked row or column keeps only its dustbin
    entry."""
    s, r = scores.shape[-2:]
    sm, rm = src_mask.bool(), ref_mask.bool()
    dt = scores.dtype
    alpha = torch.as_tensor(alpha, dtype=dt, device=scores.device)
    zero = torch.zeros((), dtype=dt, device=scores.device)
    neg = torch.full((), NEG, dtype=dt, device=scores.device)
    z = alpha.expand(scores.shape[:-2] + (s + 1, r + 1)).clone()
    z[..., :s, :r] = torch.where(sm[..., :, None] & rm[..., None, :], scores, neg)
    z[..., :s, r] = torch.where(sm, alpha, zero)
    z[..., s, :r] = torch.where(rm, alpha, zero)

    # marginals: each real point has mass 1; the dustbins absorb the rest
    ns = sm.sum(-1).to(dt)
    nr = rm.sum(-1).to(dt)
    log_mu = torch.cat([torch.where(sm, zero, neg),
                        torch.log(torch.clamp(nr, min=1.0))[..., None]], dim=-1)
    log_nu = torch.cat([torch.where(rm, zero, neg),
                        torch.log(torch.clamp(ns, min=1.0))[..., None]], dim=-1)
    u = torch.zeros(z.shape[:-1], dtype=dt, device=z.device)
    v = torch.zeros(z.shape[:-2] + (r + 1,), dtype=dt, device=z.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[..., None, :], dim=-1)
        v = log_nu - torch.logsumexp(z + u[..., :, None], dim=-2)
    return z + u[..., :, None] + v[..., None, :]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


class PatchEncoder(nn.Module):
    """A shared MLP over each patch's invariant point features, masked
    max-pooled: ``inv [B, S, M, 3]``, ``eig [B, S, 3]``, ``pmask [B, S, M]``
    -> (point features ``[B, S, M, point_dim]``, patch features ``[B, S,
    dim]``)."""

    def __init__(self, cfg: GeoModelConfig):
        super().__init__()
        self.Dense_0 = nn.Linear(3, cfg.point_dim)
        self.Dense_1 = nn.Linear(cfg.point_dim, cfg.point_dim)
        self.Dense_2 = nn.Linear(cfg.point_dim + 3, cfg.dim)

    def forward(self, inv, eig, pmask):
        h = torch.relu(self.Dense_1(torch.relu(self.Dense_0(inv))))
        g = torch.where(pmask[..., None], h, NEG).amax(dim=-2)
        g = torch.where(pmask.any(dim=-1)[..., None], g, 0.0)
        return h, self.Dense_2(torch.cat([g, eig], dim=-1))


class GeometricStructure(nn.Module):
    """Pairwise geometric embedding ``[B, S, S, dim]`` of superpoints
    ``pts [B, S, 3]`` (``mask [B, S]``): distance and triplet-angle terms."""

    def __init__(self, cfg: GeoModelConfig):
        super().__init__()
        self.cfg = cfg
        self.proj_d = nn.Linear(cfg.dim, cfg.dim)
        self.proj_a = nn.Linear(cfg.dim, cfg.dim)

    def forward(self, pts, mask):
        c = self.cfg
        diff = pts[:, :, None, :] - pts[:, None, :, :]                    # [B, S, S, 3]
        dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
        r = self.proj_d(sinusoidal_embedding(dist / c.sigma_d, c.dim))

        # triplet angles through each point's k nearest valid neighbours;
        # a stable sort keeps the lower index on ties, as lax.top_k does
        s = pts.shape[1]
        k = min(c.angle_k, max(s - 1, 1))
        inf = torch.full((), math.inf, dtype=dist.dtype, device=dist.device)
        d_masked = torch.where(mask[:, None, :], dist, inf)
        eye = torch.eye(s, dtype=torch.bool, device=pts.device)
        d_masked = torch.where(eye, inf, d_masked)
        nbr = torch.sort(d_masked, dim=-1, stable=True).indices[..., :k]  # [B, S, k]
        rows = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
        v_n = pts[rows, nbr] - pts[:, :, None, :]                        # [B, S, k, 3]
        # angle between (p_x - p_i) and (p_j - p_i): [B, S, k, S]
        dots = torch.einsum("bikd,bijd->bikj", v_n, -diff)
        nn_n = torch.linalg.vector_norm(v_n, dim=-1)[..., None]
        nd = torch.linalg.vector_norm(diff, dim=-1)[:, :, None, :]
        cos = dots / torch.clamp(nn_n * nd, min=1e-9)
        ang = torch.arccos(torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6))
        emb_a = self.proj_a(sinusoidal_embedding(ang * (c.sigma_d * 10.0), c.dim))
        return r + emb_a.amax(dim=2)


class _Block(nn.Module):
    """The attention, residual, LayerNorm and feed-forward shared by both
    attention kinds."""

    def __init__(self, cfg: GeoModelConfig, geometric: bool):
        super().__init__()
        d = cfg.dim
        self.heads = cfg.heads
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        if geometric:
            self.r = nn.Linear(d, d)
        self.o = nn.Linear(d, d)
        self.LayerNorm_0 = nn.LayerNorm(d, eps=1e-6)
        self.ff1 = nn.Linear(d, 2 * d)
        self.ff2 = nn.Linear(2 * d, d)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=1e-6)

    def _attend(self, x, y, ymask, r=None):
        b, s, d = x.shape
        h = self.heads
        dh = d // h
        q = self.q(x).reshape(b, s, h, dh)
        k = self.k(y).reshape(b, y.shape[1], h, dh)
        v = self.v(y).reshape(b, y.shape[1], h, dh)
        logits = torch.einsum("bihd,bjhd->bhij", q, k)
        if r is not None:
            rk = self.r(r).reshape(b, r.shape[1], r.shape[2], h, dh)
            logits = logits + torch.einsum("bihd,bijhd->bhij", q, rk)
        logits = logits / math.sqrt(dh)
        logits = torch.where(ymask[:, None, None, :], logits, NEG)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, s, d)
        x = self.LayerNorm_0(x + self.o(out))
        return self.LayerNorm_1(x + self.ff2(torch.relu(self.ff1(x))))


class GeoSelfAttention(_Block):
    """Self-attention with the geometric bias: ``x [B, S, dim]``, ``r [B,
    S, S, dim]``, ``mask [B, S]``."""

    def __init__(self, cfg: GeoModelConfig):
        super().__init__(cfg, geometric=True)

    def forward(self, x, r, mask):
        return self._attend(x, x, mask, r)


class CrossAttention(_Block):
    """Cross-attention of ``x`` over ``y`` (``ymask``)."""

    def __init__(self, cfg: GeoModelConfig):
        super().__init__(cfg, geometric=False)

    def forward(self, x, y, ymask):
        return self._attend(x, y, ymask)


class GeoRegModel(nn.Module):
    """The matcher over a batch of pairs. Inputs (``B`` pairs, static
    shapes): superpoints ``src_sp, ref_sp [B, S, 3]``, invariant patch
    features ``src_inv, ref_inv [B, S, M, 3]``, spectra ``src_eig, ref_eig
    [B, S, 3]``, patch-point masks ``[B, S, M]`` and superpoint masks ``[B,
    S]``. Returns ``log_assign [B, S+1, S+1]``, the unit superpoint
    features ``src_feats / ref_feats [B, S, dim]``, the unit fine features
    ``src_pf / ref_pf [B, S, M, point_dim]``, and the fine stage's
    ``fine_temp`` / ``fine_alpha`` (the parameters)."""

    def __init__(self, cfg: GeoModelConfig = GeoModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_encoder = PatchEncoder(cfg)
        self.geo = GeometricStructure(cfg)
        for i in range(cfg.blocks):
            setattr(self, f"self{i}", GeoSelfAttention(cfg))
            setattr(self, f"cross{i}", CrossAttention(cfg))
        self.head = nn.Linear(cfg.dim, cfg.dim)
        self.inv_temp = nn.Parameter(torch.tensor(10.0))
        self.dustbin = nn.Parameter(torch.tensor(1.0))
        self.fine1 = nn.Linear(cfg.point_dim + cfg.dim, 2 * cfg.point_dim)
        self.fine2 = nn.Linear(2 * cfg.point_dim, cfg.point_dim)
        self.fine_inv_temp = nn.Parameter(torch.tensor(10.0))
        self.fine_dustbin = nn.Parameter(torch.tensor(1.0))

    def _fine_feats(self, pf, ctx):
        h = torch.cat([pf, ctx[:, :, None, :].expand(pf.shape[:3] + ctx.shape[-1:])],
                      dim=-1)
        return _unit(self.fine2(torch.relu(self.fine1(h))))

    def forward(self, src_sp, ref_sp, src_inv, ref_inv, src_eig, ref_eig,
                src_pmask, ref_pmask, src_mask, ref_mask) -> dict:
        c = self.cfg
        src_pf, xs = self.patch_encoder(src_inv, src_eig, src_pmask)
        ref_pf, xr = self.patch_encoder(ref_inv, ref_eig, ref_pmask)
        rs = self.geo(src_sp, src_mask)
        rr = self.geo(ref_sp, ref_mask)
        for i in range(c.blocks):
            sa, ca = getattr(self, f"self{i}"), getattr(self, f"cross{i}")
            xs = sa(xs, rs, src_mask)
            xr = sa(xr, rr, ref_mask)
            xs, xr = ca(xs, xr, ref_mask), ca(xr, xs, src_mask)
        xs = _unit(self.head(xs))
        xr = _unit(self.head(xr))
        # unit features need a temperature: raw cosines in [-1, 1] would
        # leave the Sinkhorn logits nearly flat
        scores = (xs @ xr.transpose(-1, -2)) * self.inv_temp
        log_assign = sinkhorn_log(scores, src_mask, ref_mask, self.dustbin,
                                  c.sinkhorn_iters)
        return {"log_assign": log_assign, "src_feats": xs, "ref_feats": xr,
                "src_pf": self._fine_feats(src_pf, xs),
                "ref_pf": self._fine_feats(ref_pf, xr),
                "fine_temp": self.fine_inv_temp, "fine_alpha": self.fine_dustbin}


def fine_log_assign(src_pf: torch.Tensor, ref_pf: torch.Tensor,
                    src_pmask: torch.Tensor, ref_pmask: torch.Tensor,
                    pairs: torch.Tensor, fine_temp, fine_alpha,
                    iters: int = 20) -> torch.Tensor:
    """Point-level Sinkhorn inside selected patch pairs, batched over pairs
    of clouds: features ``[B, S, M, pd]``, masks ``[B, S, M]``, superpoint
    index pairs ``pairs [B, K, 2]`` (padding rows any valid index, dropped
    by the caller). Returns ``[B, K, M+1, M+1]`` log assignments."""
    rows = torch.arange(pairs.shape[0], device=pairs.device)[:, None]
    i, j = pairs[..., 0].long(), pairs[..., 1].long()
    scores = (src_pf[rows, i] @ ref_pf[rows, j].transpose(-1, -2)) * fine_temp
    return sinkhorn_log(scores, src_pmask[rows, i], ref_pmask[rows, j],
                        fine_alpha, iters)
