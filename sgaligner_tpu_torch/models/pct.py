"""NaivePCT object encoder, inference form.

Counterpart of ``sgaligner_tpu/models/pct.py`` (``MaskedBatchNorm`` eval fold,
``SABlock`` fused form, ``NaivePCT`` with channel-first input and the fused
embedding / block / tail ops). Parameters carry upstream SGAligner's torch
names and shapes (``object_encoder.sa1.q_conv.weight`` is ``[32, 128, 1]``),
the names ``sgaligner_tpu/core/checkpoint.py::torch_state_dict_to_params``
maps from. Parameters are stored in float32; the forward computes in the
module's ``dtype``.

The four ops below dispatch on the tensors' device: CUDA tensors launch the
kernels of ``csrc/``, CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sgaligner_tpu_torch.ops.pct_attention import pct_block_eval
from sgaligner_tpu_torch.ops.pct_embed import embed_first, embed_second
from sgaligner_tpu_torch.ops.pct_tail import pct_tail


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
    """BatchNorm1d in eval form: the running-stat fold
    ``w = s / sqrt(var + eps)``, ``b = bias - mean·w`` computed at >= f32 and
    applied in the input dtype. (The masked batch-statistics forms come with
    training.)"""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fold(self, dtype: torch.dtype):
        sdt = _fold_dtype(dtype)
        w = self.weight.to(sdt) / torch.sqrt(self.running_var.to(sdt) + self.eps)
        b = self.bias.to(sdt) - self.running_mean.to(sdt) * w
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.fold(x.dtype)
        return x * w.to(x.dtype) + b.to(x.dtype)


class Embedding(nn.Module):
    """Upstream ``embedding``: 2 x (conv(no bias) + BN + relu)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv1x1(3, 128, bias=False)
        self.conv2 = Conv1x1(128, 128, bias=False)
        self.bn1 = MaskedBatchNorm(128)
        self.bn2 = MaskedBatchNorm(128)

    def forward(self, pts_cf, kmask, dtype):
        """pts_cf [O, 3, P] and kmask [O, 1] in ``dtype`` -> [O, P, 128]."""

        def fold(bn):
            w, b = bn.fold(dtype)
            return (w.to(dtype)[None].contiguous(), b.to(dtype)[None].contiguous())

        h0, _, _ = embed_first(pts_cf, self.conv1.kernel(dtype), kmask)
        wf0, bf0 = fold(self.bn1)
        h1, _, _ = embed_second(h0, wf0, bf0, self.conv2.kernel(dtype), kmask)
        wf1, bf1 = fold(self.bn2)
        return torch.relu(h1 * wf1 + bf1)


class SABlock(nn.Module):
    """Self-attention block (upstream pct.py SA): shared q/k weight,
    1/sqrt(da) scale, column softmax, ``x + relu(BN(trans(attn(x))))``."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.q_conv = Conv1x1(channels, channels // 4, bias=False)
        self.v_conv = Conv1x1(channels, channels)
        self.trans_conv = Conv1x1(channels, channels)
        self.after_norm = MaskedBatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        wbn, bbn = self.after_norm.fold(dt)
        return pct_block_eval(
            x, self.q_conv.kernel(dt), self.v_conv.kernel(dt),
            self.v_conv.bias_as(dt), self.trans_conv.kernel(dt),
            self.trans_conv.bias_as(dt), wbn, bbn,
            scale=True, double_norm=False)


class NaivePCT(nn.Module):
    """Embedding, 4 SA blocks, 1024-wide tail with max-pool, 2-layer head.

    Input: channel-first points ``[O, 3, P]`` and the object mask ``[O]``."""

    def __init__(self, out_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = Embedding()
        self.sa1, self.sa2, self.sa3, self.sa4 = (SABlock(128) for _ in range(4))
        self.linear = nn.ModuleList([Conv1x1(512, 1024, bias=False),
                                     MaskedBatchNorm(1024)])
        self.linear1 = Linear(1024, 512, bias=False)
        self.bn1 = MaskedBatchNorm(512)
        self.linear2 = Linear(512, out_size)
        self.bn2 = MaskedBatchNorm(out_size)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pts = points.to(dt).contiguous()
        kmask = mask.to(dt)[:, None].contiguous()
        x = self.embedding(pts, kmask, dt)
        feats = []
        for sa in (self.sa1, self.sa2, self.sa3, self.sa4):
            x = sa(x)
            feats.append(x)
        # tail: max/min of z = concat(feats)·W over points; the BN affine +
        # LeakyReLU + max-pool follow by the monotone identity (max where the
        # folded scale is positive, min where it is negative)
        pmax, pmin, _, _ = pct_tail(*feats, self.linear[0].kernel(dt), kmask)
        wbn, bbn = self.linear[1].fold(pmax.dtype)
        pooled = torch.where(wbn > 0, pmax.to(wbn.dtype), pmin.to(wbn.dtype)) * wbn + bbn
        x = F.leaky_relu(pooled, 0.2).to(dt)                           # [O, 1024]
        x = torch.relu(self.bn1(self.linear1(x, dt)))
        return torch.relu(self.bn2(self.linear2(x, dt)))
