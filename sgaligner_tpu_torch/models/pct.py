"""PCT object encoders, inference and training forms: NaivePCT (SA blocks),
SPCT (OA blocks) and FullPCT (FPS + KNN grouping, OA blocks at C = 256).

Counterpart of ``sgaligner_tpu/models/pct.py`` (``MaskedBatchNorm`` with its
running-statistics and masked batch-statistics forms, ``SABlock`` and
``OABlock`` in their fused form (``_fused_block``), ``NaivePCT`` with
channel-first input, the fused embedding / block / tail ops and the head's
two ``Dropout(0.5)``, ``SPCT``: the embedding, four OA blocks and the
1024-wide tail with its max and mean pools, ``SGModule`` and ``FullPCT``:
the neighbour embedding (3 -> 64 -> 64, then two sampling-and-grouping
blocks, 128 and 256 wide), four ``OABlock(256)``, the 1280 -> 1024 tail and
NaivePCT's head).
Parameters carry upstream SGAligner's torch names and shapes
(``object_encoder.sa1.q_conv.weight`` is ``[32, 128, 1]``), the names
``sgaligner_tpu/core/checkpoint.py::torch_state_dict_to_params`` maps from.
Parameters are stored in float32; the forward computes in the module's
``dtype``.

In eval mode the inference ops run with the running-statistics folds, each
differentiable as its JAX custom VJP is (``EmbedFirst``, ``EmbedSecond``,
``BlockEval``, ``pct_tail_pool``: the tail's indexed form and backward
kernel only when an input asks for a gradient). In train mode the autograd
Functions run (``EmbedFirst``, ``EmbedSecond``, ``BlockResidual``,
``PctTail``), the BatchNorms fold from the batch's masked
moments and update their running statistics (decay 0.9, the unbiased
variance), and the head draws its dropout from the caller's generator.
SPCT's and FullPCT's tails, and FullPCT's neighbour embedding (FPS, KNN
grouping, its 1x1 convolutions and BatchNorms), are plain torch in both
modes, as the JAX package leaves them to XLA. The ops dispatch on the
tensors' device: CUDA tensors launch the kernels of ``csrc/``, CPU tensors
take the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sgaligner_tpu_torch.models.structure import dropout
from sgaligner_tpu_torch.ops.knn import sample_and_knn_group
from sgaligner_tpu_torch.ops.pct_attention import BlockEval, BlockResidual
from sgaligner_tpu_torch.ops.pct_embed import EmbedFirst, EmbedSecond
from sgaligner_tpu_torch.ops.pct_tail import PctTail, pct_tail_pool
from sgaligner_tpu_torch.parallel.mesh import all_reduce_sum


def _fold_dtype(dtype: torch.dtype) -> torch.dtype:
    """BN folds are computed at >= f32 (f64 under f64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class Conv1x1(nn.Module):
    """Conv1d(kernel_size=1) parameters in torch layout ``[out, in, 1]``,
    applied channel-last as a dense layer."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """[in, out] in ``dtype``, contiguous."""
        return self.weight[:, :, 0].t().to(dtype).contiguous()

    def bias_as(self, dtype: torch.dtype) -> torch.Tensor:
        return self.bias.to(dtype).contiguous()


class Linear(nn.Module):
    """torch Linear parameters (``weight [out, in]``) applied in ``dtype``:
    ``x.to(dtype) @ Wᵀ + b``, like a flax Dense with ``dtype=``."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.matmul(x.to(dtype), self.weight.t().to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over valid rows only (padded object slots must not enter
    the statistics). Eval: the running-statistics fold
    ``w = s / sqrt(var + eps)``, ``b = bias - mean·w`` at >= f32, applied in
    the input dtype. Train: the same fold from the batch's masked moments,
    and the running statistics move towards them (decay 0.9, torch's
    momentum 0.1, with the unbiased variance)."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fold_from(self, mean, var, dtype: torch.dtype):
        """(w, b) at >= f32 from per-channel moments."""
        sdt = _fold_dtype(dtype)
        w = self.weight.to(sdt) / torch.sqrt(var.to(sdt) + self.eps)
        return w, self.bias.to(sdt) - mean.to(sdt) * w

    def fold(self, dtype: torch.dtype):
        """The running-statistics fold (eval)."""
        return self.fold_from(self.running_mean, self.running_var, dtype)

    @torch.no_grad()
    def update_running(self, mean, var, count) -> None:
        unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)

    def train_fold(self, moments, dtype: torch.dtype):
        """``moments = (mean, var, count)`` from the caller's masked sums:
        updates the running statistics and returns the batch fold."""
        mean, var, count = moments
        self.update_running(mean, var, count)
        return self.fold_from(mean, var, dtype)

    def batch_moments(self, x: torch.Tensor, mask: torch.Tensor, mesh=None):
        """One-pass masked moments of x [..., C] over the rows where mask
        (broadcastable to x[..., 0]) is true, accumulated at >= f32; under
        data parallel (``mesh``) the count and sums over every rank's rows."""
        sdt = _fold_dtype(x.dtype)
        rows_per_mask = x.numel() // (mask.numel() * x.shape[-1])
        xm = x * mask.to(x.dtype)[..., None]
        red = tuple(range(x.dim() - 1))
        valid, s1, s2 = all_reduce_sum(mesh, mask.to(sdt).sum(), xm.sum(red, dtype=sdt),
                                       torch.square(xm).sum(red, dtype=sdt))
        count = torch.clamp_min(valid * rows_per_mask, 1.0)
        mean = s1 / count
        ex2 = s2 / count
        return mean, torch.clamp_min(ex2 - mean * mean, 0.0), count

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                mesh=None) -> torch.Tensor:
        if self.training:
            w, b = self.train_fold(self.batch_moments(x, mask, mesh), x.dtype)
        else:
            w, b = self.fold(x.dtype)
        return x * w.to(x.dtype) + b.to(x.dtype)


def moments_from_sums(ssum, ssumsq, count):
    """(mean, var, count) from masked per-channel sums [1, C]."""
    mean = ssum[0] / count
    return mean, torch.clamp_min(ssumsq[0] / count - mean * mean, 0.0), count


def valid_rows(mask: torch.Tensor, per_object: int, mesh=None) -> torch.Tensor:
    """The BatchNorm statistics' valid rows, as the JAX model counts them
    (f32): max(valid objects · ``per_object``, 1), the objects of every rank
    under data parallel (``mesh``)."""
    (valid,) = all_reduce_sum(mesh, mask.to(torch.float32).sum())
    return torch.clamp_min(valid * per_object, 1.0)


class Embedding(nn.Module):
    """Upstream ``embedding``: 2 x (conv(no bias) + BN + relu)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv1x1(3, 128, bias=False)
        self.conv2 = Conv1x1(128, 128, bias=False)
        self.bn1 = MaskedBatchNorm(128)
        self.bn2 = MaskedBatchNorm(128)

    def forward(self, pts_cf, kmask, dtype, count=None, mesh=None):
        """pts_cf [O, 3, P] and kmask [O, 1] in ``dtype`` -> [O, P, 128].
        ``count`` (train mode): the valid rows, max(valid objects · P, 1);
        under data parallel (``mesh``) the kernels' BN sums are summed over
        the ranks before the folds."""

        def fold(bn, s1, s2):
            if self.training:
                s1, s2 = all_reduce_sum(mesh, s1, s2)
                w, b = bn.train_fold(moments_from_sums(s1, s2, count), dtype)
            else:
                w, b = bn.fold(dtype)
            return (w.to(dtype)[None].contiguous(), b.to(dtype)[None].contiguous())

        # both modes run the autograd Functions (the JAX ops carry the same
        # custom VJP in either mode); with gradients off they save nothing
        w0, w1 = self.conv1.kernel(dtype), self.conv2.kernel(dtype)
        h0, s0a, s0b = EmbedFirst.apply(pts_cf.detach(), w0, kmask)
        wf0, bf0 = fold(self.bn1, s0a, s0b)
        h1, s1a, s1b = EmbedSecond.apply(h0, wf0, bf0, w1, kmask)
        wf1, bf1 = fold(self.bn2, s1a, s1b)
        return torch.relu(h1 * wf1 + bf1)


class SABlock(nn.Module):
    """Self-attention block (upstream pct.py SA): shared q/k weight,
    1/sqrt(da) scale, column softmax, ``x + relu(BN(trans(attn(x))))``."""

    scale, double_norm = True, False

    def __init__(self, channels: int = 128):
        super().__init__()
        self.q_conv = Conv1x1(channels, channels // 4, bias=False)
        self.v_conv = Conv1x1(channels, channels)
        self.trans_conv = Conv1x1(channels, channels)
        self.after_norm = MaskedBatchNorm(channels)

    def forward(self, x: torch.Tensor, kmask: torch.Tensor | None = None,
                count: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
        """x [O, P, C] in the compute dtype; train mode also takes the
        object mask ``kmask [O, 1]`` (x's dtype), the valid-row count and,
        under data parallel, the ``mesh`` its BN sums are summed over."""
        dt = x.dtype
        weights = (self.q_conv.kernel(dt), self.v_conv.kernel(dt),
                   self.v_conv.bias_as(dt), self.trans_conv.kernel(dt),
                   self.trans_conv.bias_as(dt))
        bn = self.after_norm
        if not self.training:
            wbn, bbn = bn.fold(dt)
            return BlockEval.apply(x, *weights, wbn, bbn, self.scale,
                                   self.double_norm)
        x_next, ssum, ssumsq = BlockResidual.apply(
            x, *weights, bn.weight, bn.bias, kmask, count, self.scale,
            self.double_norm, bn.eps, mesh)
        bn.update_running(*moments_from_sums(ssum.detach(), ssumsq.detach(), count))
        return x_next


class OABlock(SABlock):
    """Offset-attention block (upstream pct.py OA): SABlock's parameters and
    forms without the energy scale, the rows re-normalised by ``1e-9 + Σ``
    after the column softmax, and ``x + relu(BN(trans(x - attn(x))))``."""

    scale, double_norm = False, True


class NaivePCT(nn.Module):
    """Embedding, 4 SA blocks, 1024-wide tail with max-pool, 2-layer head.

    Input: channel-first points ``[O, 3, P]`` and the object mask ``[O]``.
    ``dropout``: the head's two dropout rates (0.5, as upstream), applied in
    train mode from the generator the caller passes. Under data parallel
    (``mesh``: this rank's objects, a block of the batch's) every BatchNorm
    folds from the whole batch's statistics and the dropout masks are the
    whole batch's rows for this block."""

    def __init__(self, out_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout = 0.5
        self.embedding = Embedding()
        self.sa1, self.sa2, self.sa3, self.sa4 = (SABlock(128) for _ in range(4))
        self.linear = nn.ModuleList([Conv1x1(512, 1024, bias=False),
                                     MaskedBatchNorm(1024)])
        self.linear1 = Linear(1024, 512, bias=False)
        self.bn1 = MaskedBatchNorm(512)
        self.linear2 = Linear(512, out_size)
        self.bn2 = MaskedBatchNorm(out_size)

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        dt = self.dtype
        pts = points.to(dt).contiguous()
        kmask = mask.to(dt)[:, None].contiguous()
        train = self.training
        count = valid_rows(mask, pts.shape[-1], mesh) if train else None
        x = self.embedding(pts, kmask, dt, count, mesh)
        feats = []
        for sa in (self.sa1, self.sa2, self.sa3, self.sa4):
            x = sa(x, kmask, count, mesh)
            feats.append(x)
        # tail: max/min of z = concat(feats)·W over points; the BN affine +
        # LeakyReLU + max-pool follow by the monotone identity (max where the
        # folded scale is positive, min where it is negative)
        w = self.linear[0].kernel(dt)
        if train:
            pmax, pmin, ssum, ssumsq = PctTail.apply(*feats, w, kmask)
            ssum, ssumsq = all_reduce_sum(mesh, ssum, ssumsq)
            wbn, bbn = self.linear[1].train_fold(
                moments_from_sums(ssum, ssumsq, count), pmax.dtype)
        else:
            pmax, pmin, _, _ = pct_tail_pool(*feats, w, kmask)
            wbn, bbn = self.linear[1].fold(pmax.dtype)
        pooled = torch.where(wbn > 0, pmax.to(wbn.dtype), pmin.to(wbn.dtype)) * wbn + bbn
        x = F.leaky_relu(pooled, 0.2).to(dt)                           # [O, 1024]
        x = torch.relu(self.bn1(self.linear1(x, dt), mask, mesh))
        if train:
            x = dropout(x, self.dropout, generator, mesh)
        x = torch.relu(self.bn2(self.linear2(x, dt), mask, mesh))
        if train:
            x = dropout(x, self.dropout, generator, mesh)
        return x


class SPCT(nn.Module):
    """SPCT (upstream pct.py SPCT): NaivePCT's embedding, four OA blocks and
    the 1024-wide tail, with no head: a feature extractor.

    Input: points-last ``[O, P, 3]`` (the JAX layout) and the object mask
    ``[O]``. Returns ``(x [O, P, 1024], max over P [O, 1024], mean over P
    [O, 1024])`` in the module's dtype, pads included."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = Embedding()
        self.sa1, self.sa2, self.sa3, self.sa4 = (OABlock(128) for _ in range(4))
        self.linear = nn.ModuleList([Conv1x1(512, 1024, bias=False),
                                     MaskedBatchNorm(1024)])

    def forward(self, points: torch.Tensor, mask: torch.Tensor):
        dt = self.dtype
        pts = points.to(dt).transpose(1, 2).contiguous()             # [O, 3, P]
        kmask = mask.to(dt)[:, None].contiguous()
        count = valid_rows(mask, pts.shape[-1]) if self.training else None
        x = self.embedding(pts, kmask, dt, count)
        feats = []
        for sa in (self.sa1, self.sa2, self.sa3, self.sa4):
            x = sa(x, kmask, count)
            feats.append(x)
        z = torch.matmul(torch.cat(feats, dim=-1), self.linear[0].kernel(dt))
        x = F.leaky_relu(self.linear[1](z, mask[:, None]), 0.2)      # [O, P, 1024]
        return x, x.amax(dim=1), x.mean(dim=1)


def _conv_bn_relu(x, conv: Conv1x1, bn: MaskedBatchNorm, mask) -> torch.Tensor:
    """relu(BN(x·W)) in x's dtype, BN over the rows ``mask`` marks."""
    return torch.relu(bn(torch.matmul(x, conv.kernel(x.dtype)), mask))


class SGModule(nn.Module):
    """Sampling and grouping (upstream pct.py SG): FPS ``s`` centres, the
    features of each centre's 32 nearest points grouped around it
    (``ops.knn.sample_and_knn_group``), 2 x (1x1 conv + BN + relu), max over
    the group. The BatchNorms count a valid object's s·32 rows."""

    k = 32

    def __init__(self, s: int, in_channels: int, out_channels: int):
        super().__init__()
        self.s = s
        self.conv1 = Conv1x1(in_channels, out_channels, bias=False)
        self.conv2 = Conv1x1(out_channels, out_channels, bias=False)
        self.bn1 = MaskedBatchNorm(out_channels)
        self.bn2 = MaskedBatchNorm(out_channels)

    def forward(self, features: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """features [O, N, D] and coords [O, N, 3] in the compute dtype, mask
        [O] -> (the centres [O, s, 3], their features [O, s, C])."""
        new_xyz, grouped = sample_and_knn_group(self.s, self.k, coords, features)
        o, s, k, d = grouped.shape
        x = grouped.reshape(o * s, k, d)
        gm = mask[:, None].expand(o, s).reshape(o * s, 1)
        x = _conv_bn_relu(x, self.conv1, self.bn1, gm)
        x = _conv_bn_relu(x, self.conv2, self.bn2, gm)
        return new_xyz, x.amax(dim=1).reshape(o, s, -1)


class NeighborEmbedding(nn.Module):
    """Upstream ``NeighborEmbedding``: 2 x (1x1 conv 3 -> 64 -> 64 + BN +
    relu) per point, then ``sg1`` (``samples[0]`` centres, 128 wide) and
    ``sg2`` (``samples[1]`` centres of sg1's, 256 wide)."""

    def __init__(self, samples: tuple[int, int] = (512, 256)):
        super().__init__()
        self.conv1 = Conv1x1(3, 64, bias=False)
        self.conv2 = Conv1x1(64, 64, bias=False)
        self.bn1 = MaskedBatchNorm(64)
        self.bn2 = MaskedBatchNorm(64)
        self.sg1 = SGModule(samples[0], 128, 128)
        self.sg2 = SGModule(samples[1], 256, 256)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """xyz [O, N, 3] in the compute dtype, mask [O] -> [O, samples[1], 256]."""
        pm = mask[:, None]
        x = _conv_bn_relu(xyz, self.conv1, self.bn1, pm)
        x = _conv_bn_relu(x, self.conv2, self.bn2, pm)
        xyz1, x = self.sg1(x, xyz, mask)
        return self.sg2(x, xyz1, mask)[1]


class FullPCT(nn.Module):
    """FullPCT (upstream pct.py PCT): the neighbour embedding, four OA
    blocks at C = 256 (the kernels of ``csrc/pct_attention_c256.cu``), the
    concatenation of the five 256-wide features, 1280 -> 1024 + BN + leaky
    relu (0.2) + max over the sampled points, and NaivePCT's head.

    Input: points-last ``[O, N, 3]`` (the JAX layout) and the object mask
    ``[O]``; returns ``[O, out_size]`` in the module's dtype. ``dropout``:
    the head's two rates (0.5), applied in train mode from the generator the
    caller passes. ``engine.factory.build_full_pct`` builds one with seeded
    weights on the card (or the CPU)."""

    def __init__(self, out_size: int = 256, samples: tuple[int, int] = (512, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout = 0.5
        self.neighbor_embedding = NeighborEmbedding(samples)
        self.oa1, self.oa2, self.oa3, self.oa4 = (OABlock(256) for _ in range(4))
        self.linear = nn.ModuleList([Conv1x1(5 * 256, 1024, bias=False),
                                     MaskedBatchNorm(1024)])
        self.linear1 = Linear(1024, 512, bias=False)
        self.bn1 = MaskedBatchNorm(512)
        self.linear2 = Linear(512, out_size)
        self.bn2 = MaskedBatchNorm(out_size)

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = self.neighbor_embedding(points.to(dt), mask)              # [O, S, 256]
        kmask = mask.to(dt)[:, None].contiguous()
        count = valid_rows(mask, x.shape[1]) if self.training else None
        feats = [x]
        for oa in (self.oa1, self.oa2, self.oa3, self.oa4):
            x = oa(x, kmask, count)
            feats.append(x)
        z = torch.matmul(torch.cat(feats, dim=-1), self.linear[0].kernel(dt))
        x = F.leaky_relu(self.linear[1](z, mask[:, None]), 0.2).amax(dim=1)  # [O, 1024]
        x = torch.relu(self.bn1(self.linear1(x, dt), mask))
        if self.training:
            x = dropout(x, self.dropout, generator)
        x = torch.relu(self.bn2(self.linear2(x, dt), mask))
        if self.training:
            x = dropout(x, self.dropout, generator)
        return x
