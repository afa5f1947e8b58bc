"""Factories: ``build_model``, ``build_full_pct``, ``build_lr_schedule``,
``build_optimizer``.

Counterpart of ``sgaligner_tpu/engine/factory.py``: the SGAligner encoder,
or EVA for ``model_name: eva`` (``loss_kind`` names its objective). The
weights are drawn on the CPU from ``generator`` (so one seed
gives the same weights on every device) and then moved to ``device``, which
is the card unless the caller asks for ``"cpu"``. The optimizer is
``torch.optim.Adam`` with upstream's settings, over the model's and the
objective's parameters.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.models.eva import EVA
from sgaligner_tpu_torch.models.pct import FullPCT
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.ops.objective import OverallLoss, OverallNCALoss

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
                generator: torch.Generator | None = None
                ) -> MultiModalEncoder | EVA:
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    dtype = DTYPES[cfg.tpu.compute_dtype]
    if cfg.model_name == "eva":
        model = EVA(modules=tuple(cfg.modules), rel_dim=cfg.model.rel_dim,
                    attr_dim=cfg.model.attr_dim, emb_dim=cfg.model.emb_dim,
                    dropout=cfg.model.dropout,
                    pointnet_bn_mode=cfg.model.pointnet_bn_mode, dtype=dtype)
    else:
        model = MultiModalEncoder(
            modules=tuple(cfg.modules),
            rel_dim=cfg.model.rel_dim,
            attr_dim=cfg.model.attr_dim,
            emb_dim=cfg.model.emb_dim,
            pt_out_dim=cfg.model.pt_out_dim,
            hidden_units=tuple(cfg.model.hidden_units),
            heads=tuple(cfg.model.heads),
            dropout=cfg.model.dropout,
            pointnet_bn_mode=cfg.model.pointnet_bn_mode,
            dtype=dtype,
        )
    init_weights(model, generator)
    return model.to(device)


def build_full_pct(device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                   seed: int = 0, **kwargs) -> FullPCT:
    """FullPCT (``models.pct.FullPCT``; ``kwargs``: ``out_size``,
    ``samples``) with ``init_weights``' seeded weights on ``device``."""
    device = resolve_device(device)
    model = FullPCT(dtype=dtype, **kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def loss_kind(cfg: Config) -> str:
    return "nca" if cfg.model_name == "eva" else "overall"


def build_objective(cfg: Config) -> OverallLoss | OverallNCALoss:
    """The objective of ``loss_kind(cfg)`` (its Kendall log-variances at
    zero for SGAligner's)."""
    if loss_kind(cfg) == "nca":
        return OverallNCALoss(cfg.modules)
    return OverallLoss(cfg.modules, zoom=cfg.loss.zoom)


def build_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Learning rate as a function of the number of updates applied so far
    (optax's schedule count, which a skipped non-finite step does not
    advance). "none" is upstream's constant rate; "exponential" is
    ``lr · lr_decay^(count // (steps_per_epoch · lr_decay_steps))``;
    "cosine" and "warmup-cosine" are optax's ``cosine_decay_schedule`` and
    ``warmup_cosine_decay_schedule`` (from 0 to lr, then down to 0) over
    ``steps_per_epoch · max_epoch`` updates."""
    o = cfg.optim
    if o.scheduler in ("none", "", None):
        return lambda count: o.lr
    if o.scheduler == "exponential":
        per = max(o.steps_per_epoch, 1) * max(o.lr_decay_steps, 1)
        return lambda count: o.lr * (o.lr_decay ** (count // per))
    total = max(o.steps_per_epoch, 1) * o.max_epoch

    def cosine(count: int, steps: int) -> float:
        frac = min(max(count, 0), steps) / steps
        return 0.5 * (1.0 + math.cos(math.pi * frac))

    if o.scheduler == "cosine":
        decay = max(total, 1)
        return lambda count: o.lr * cosine(count, decay)
    if o.scheduler == "warmup-cosine":
        warm = max(o.warmup_steps, 1)
        decay = max(total, o.warmup_steps + 1)

        def schedule(count: int) -> float:
            if count < warm:
                return o.lr * count / warm
            return o.lr * cosine(count - warm, decay - warm)

        return schedule
    raise ValueError(f"unknown scheduler {o.scheduler!r}")


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Adam:
    """Adam with upstream's settings; its weight decay is L2 added to the
    gradient before the moments (optax ``add_decayed_weights`` then
    ``scale_by_adam``, which covers the loss parameters too). Gradient
    accumulation (``optim.grad_acc_steps``, optax ``MultiSteps``) and the
    skip of steps with a non-finite gradient are the train step's
    (``engine/train_step.py``)."""
    return torch.optim.Adam(params, lr=cfg.optim.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.optim.weight_decay)
