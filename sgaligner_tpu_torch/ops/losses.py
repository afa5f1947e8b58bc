"""Loss helpers. Only what the serving path needs so far: ``l2_normalize``
(counterpart of ``sgaligner_tpu/ops/losses.py::l2_normalize``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch.nn.functional.normalize semantics, x / max(||x||, 1e-12), written
    as x * rsqrt(max(||x||², 1e-24)) like the JAX package (NaN-free gradient
    at exact-zero padded rows)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-24))
