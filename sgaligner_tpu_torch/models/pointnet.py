"""PointNet object encoder, parity mode.

Counterpart of ``sgaligner_tpu/models/pointnet.py::PointNetEncoder`` with
``bn_mode="parity"``: upstream PointNetfeat calls its BatchNorms but drops
their outputs, so the network is conv -> relu (x3) -> max-pool over points.
Parameters carry upstream's names and shapes (``conv{1,2,3}.weight
[out, in, 1]`` and ``.bias``, which
``sgaligner_tpu/core/checkpoint.py::torch_state_dict_to_params`` reads);
they are stored in float32 and the op computes in the module's ``dtype``.

With gradients on, the forward goes through ``PointNetFused`` (the argmax
output, then the backward kernel); without, through ``pointnet_fwd`` alone.
"""

from __future__ import annotations

import torch
from torch import nn

from sgaligner_tpu_torch.models.pct import Conv1x1
from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fused, pointnet_fwd


class PointNetEncoder(nn.Module):
    def __init__(self, out_size: int = 256, bn_mode: str = "parity",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if bn_mode != "parity":
            raise NotImplementedError(
                f"PointNetEncoder bn_mode={bn_mode!r} is not ported yet "
                "(only 'parity')")
        self.dtype = dtype
        self.conv1 = Conv1x1(3, 64)
        self.conv2 = Conv1x1(64, 128)
        self.conv3 = Conv1x1(128, out_size)

    def forward(self, points: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        """points: channel-first ``[O, 3, P]`` -> ``[O, out_size]``. ``mask``,
        ``generator`` and ``mesh`` are unused (parity mode has no batch
        statistics and no dropout, so each object is computed alone); they
        keep the call the same as NaivePCT's."""
        dt = self.dtype
        x = points.to(dt).contiguous()
        args = []
        for conv in (self.conv1, self.conv2, self.conv3):
            args += [conv.kernel(dt), conv.bias_as(dt)[None]]
        if torch.is_grad_enabled() and self.conv1.weight.requires_grad:
            # points are data: their gradient is zero by design
            return pointnet_fused(x.detach(), *args)
        return pointnet_fwd(x, *args, with_argmax=False)[0]
