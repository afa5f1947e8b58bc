"""Model factory: ``build_model(cfg, device, generator)``.

Counterpart of ``sgaligner_tpu/engine/factory.py::build_model`` for the
SGAligner encoder. The weights are drawn on the CPU from ``generator`` (so
one seed gives the same weights on every device) and then moved to
``device``, which is the card unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import math

import torch

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain path")
    return device


@torch.no_grad()
def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: N(0, 1/fan_in) for weights (fan_in = second
    dim), N(0, 1/out) for GAT attention vectors; biases and BN shifts zero,
    BN scales and the fusion weights one; running stats mean 0, var 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("att_src", "att_dst"):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
        elif leaf == "weight" and p.dim() >= 2 and not name.startswith("fusion"):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        buf.fill_(1.0 if name.endswith("running_var") else 0.0)


def build_model(cfg: Config, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> MultiModalEncoder:
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = MultiModalEncoder(
        modules=tuple(cfg.modules),
        rel_dim=cfg.model.rel_dim,
        attr_dim=cfg.model.attr_dim,
        emb_dim=cfg.model.emb_dim,
        pt_out_dim=cfg.model.pt_out_dim,
        hidden_units=tuple(cfg.model.hidden_units),
        heads=tuple(cfg.model.heads),
        dtype=DTYPES[cfg.tpu.compute_dtype],
    )
    init_weights(model, generator)
    return model.to(device)
