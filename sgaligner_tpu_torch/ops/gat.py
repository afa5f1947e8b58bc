"""Dense masked graph convolutions (torch-geometric GATConv and GCNConv
semantics).

Counterpart of ``sgaligner_tpu/ops/gat.py`` (``gat_conv``, ``gcn_conv``):
every graph of every pair runs at once over a dense ``[G, N, N]``
adjacency; ``adj[g, i, j]`` is the edge j -> i. GAT: scores
``e_ij = LeakyReLU(att_src·(W x_j) + att_dst·(W x_i), 0.2)``, softmax over
the incoming edges of i with self-loops added, heads concatenated, plus
bias. GCN: ``Â = A + I`` normalised by ``deg_i^-1/2 deg_j^-1/2`` (deg the
in-degree), times ``x W``, plus bias. Padded nodes output zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def add_self_loops(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """adj: [..., N, N] bool; adds i -> i for valid nodes."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    return adj | (eye & node_mask[..., None, :] & node_mask[..., :, None])


def gat_conv(x, adj, node_mask, weight, att_src, att_dst, bias,
             negative_slope: float = 0.2):
    """x [G, N, Din]; adj [G, N, N] bool; node_mask [G, N] bool;
    weight [Din, H, Dout]; att_src / att_dst [H, Dout]; bias [H*Dout].
    Returns [G, N, H*Dout]."""
    g, n, _ = x.shape
    h, dout = att_src.shape
    xp = torch.einsum("gnd,dhe->gnhe", x, weight)               # [G, N, H, Do]
    a_src = torch.einsum("gnhe,he->gnh", xp, att_src)
    a_dst = torch.einsum("gnhe,he->gnh", xp, att_dst)
    # scores[g, h, i, j] = lrelu(a_dst[i] + a_src[j])
    scores = a_dst.permute(0, 2, 1)[:, :, :, None] + a_src.permute(0, 2, 1)[:, :, None, :]
    scores = F.leaky_relu(scores, negative_slope)
    mask = add_self_loops(adj, node_mask)[:, None]               # [G, 1, N, N]
    neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device)
    scores = torch.where(mask, scores, neg)
    smax = scores.amax(dim=-1, keepdim=True)
    has_any = smax > NEG_INF / 2
    expd = torch.exp(scores - torch.where(has_any, smax, torch.zeros_like(smax)))
    expd = torch.where(mask, expd, torch.zeros_like(expd))
    denom = expd.sum(dim=-1, keepdim=True)
    alpha = expd / torch.clamp(denom, min=1e-16)                 # [G, H, N, N]
    out = torch.einsum("ghij,gjhe->gihe", alpha, xp).reshape(g, n, h * dout)
    if bias is not None:
        out = out + bias
    return out * node_mask[..., None].to(out.dtype)


def gcn_conv(x, adj, node_mask, weight, bias):
    """x [G, N, Din]; adj [G, N, N] bool; node_mask [G, N] bool;
    weight [Din, Dout]; bias [Dout] or None. Returns [G, N, Dout]."""
    a_hat = add_self_loops(adj, node_mask).to(x.dtype)          # [G, N, N]
    deg = a_hat.sum(dim=-1)                                     # in-degree of i
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                           torch.zeros_like(deg))
    norm = a_hat * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]
    out = torch.einsum("gij,gjd->gid", norm, x @ weight)
    if bias is not None:
        out = out + bias
    return out * node_mask[..., None].to(out.dtype)
