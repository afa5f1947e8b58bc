"""Train, eval and serving steps.

Counterpart of ``sgaligner_tpu/engine/train_step.py``: ``TrainState``,
``create_train_state``, ``make_train_step`` (forward, ``OverallLoss``,
backward, Adam with the non-finite skip), ``make_eval_step`` (loss, ranks,
MRR / Hits@K components, SGAR, ``alignment_score``) and the serving steps
(``make_serving_step``, ``serve_queue``). The JAX steps take parameter trees
and return new ones; here the model and the objective hold their
parameters, the train step updates them in place, and every step takes the
batch as a dict of tensors on the model's device (``data.batch.to_device``).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.engine.factory import build_lr_schedule, build_optimizer
from sgaligner_tpu_torch.ops import metrics as M
from sgaligner_tpu_torch.ops.objective import OverallLoss


@dataclass
class TrainState:
    """``updates`` counts the optimizer updates applied, which is the
    schedule's count; a skipped non-finite step advances ``skipped`` but not
    ``updates`` or Adam's state. ``step`` counts every call of the train
    step, as the JAX state's does."""

    model: torch.nn.Module
    objective: OverallLoss
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    generator: torch.Generator      # dropout masks, on the model's device
    updates: int = 0
    skipped: int = 0

    @property
    def step(self) -> int:
        return self.updates + self.skipped

    def parameters(self) -> list[torch.nn.Parameter]:
        return [*self.model.parameters(), *self.objective.parameters()]


def create_train_state(model, cfg: Config, objective: OverallLoss | None = None
                       ) -> TrainState:
    """Objective (log-variances at zero), Adam over model and objective
    parameters, and a dropout generator seeded from ``cfg.seed`` on the
    model's device."""
    device = next(model.parameters()).device
    if objective is None:
        objective = OverallLoss(model.modal_names, zoom=cfg.loss.zoom)
    objective = objective.to(device)
    params = [*model.parameters(), *objective.parameters()]
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return TrainState(model=model, objective=objective,
                      optimizer=build_optimizer(cfg, params),
                      schedule=build_lr_schedule(cfg), generator=generator)


def make_train_step(modules: tuple[str, ...]):
    """Returns ``step(state, batch) -> losses``: ``loss`` and its terms
    ``icl_loss_unimodal``, ``icl_loss_multimodal``, ``ial_loss``
    (detached). The update is skipped when any gradient is non-finite
    (optax ``apply_if_finite``): parameters and Adam's state stay as they
    were. Deciding that reads one flag back from the device per step.
    BatchNorm running statistics move in the forward, on a skipped step too,
    as the JAX step assigns the new ``batch_stats`` either way."""

    def step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        if tuple(modules) != state.objective.modal_names:
            raise ValueError(f"objective modules {state.objective.modal_names} "
                             f"!= {tuple(modules)}")
        state.model.train(True)
        state.optimizer.zero_grad(set_to_none=True)
        embs = state.model(batch, generator=state.generator)
        losses = state.objective(embs, batch)
        losses["loss"].backward()
        grads = [p.grad for p in state.parameters() if p.grad is not None]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if bool(finite):
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.updates)
            state.optimizer.step()
            state.updates += 1
        else:
            state.skipped += 1
        return {k: v.detach() for k, v in losses.items()}

    return step


def _rank_metrics(embs, modules, ks, batch, with_sim=False, eval_extras=False):
    key = "joint" if len(modules) > 1 else modules[0]
    b, two_n = batch["obj_mask"].shape
    emb = embs[key].reshape(b, two_n, -1)
    sim = M.cosine_sim_matrix(emb, batch["obj_mask"])
    ranks, mask = M.anchor_ranks(sim, batch["e1i"], batch["e2i"],
                                 batch["anchor_mask"])
    rr_sum, rr_count = M.mrr_from_ranks(ranks, mask)
    out = {
        "rr_sum": rr_sum,
        "rr_count": rr_count,
        "alignment_score": M.alignment_score(sim, batch["n_src"],
                                             batch["n_ref"], two_n // 2),
    }
    if eval_extras:
        out["pair_valid"] = batch["anchor_mask"].any(dim=1)
        out["sgar"] = M.sgar(sim, batch["e1i"], batch["e2i"],
                             batch["anchor_mask"])
    if with_sim:
        out["sim"] = sim
    for k, (correct, total) in M.hits_at_k_from_ranks(ranks, mask, ks).items():
        out[f"hits@{k}"] = (correct, total)
    return out


def serving_metrics(model, modules: tuple[str, ...], ks: tuple[int, ...],
                    batch: dict) -> dict:
    """One batch: the metric components the host accumulates."""
    return _rank_metrics(model(batch), modules, ks, batch)


def make_serving_step(model, modules: tuple[str, ...],
                      ks: tuple[int, ...] = (1, 2, 3, 4, 5)):
    """Returns ``step(batch) -> metric components`` (inference mode; puts
    the model in eval mode)."""

    @torch.inference_mode()
    def step(batch: dict) -> dict:
        model.train(False)
        return serving_metrics(model, modules, ks, batch)

    return step


def make_eval_step(model, objective: OverallLoss, modules: tuple[str, ...],
                   ks: tuple[int, ...] = (1, 2, 3, 4, 5),
                   with_sim: bool = False):
    """Returns ``step(batch) -> metric components``: ``loss``, ``rr_sum``,
    ``rr_count``, ``pair_valid``, ``sgar`` ({mode: [B]}),
    ``alignment_score``, ``hits@k`` and, with ``with_sim``, the per-pair
    similarity matrices ``sim``."""

    @torch.inference_mode()
    def step(batch: dict) -> dict:
        model.train(False)
        embs = model(batch)
        out = {"loss": objective(embs, batch)["loss"]}
        out.update(_rank_metrics(embs, modules, ks, batch, with_sim=with_sim,
                                 eval_extras=True))
        return out

    return step


def serve_queue(model, modules: tuple[str, ...], batches: list[dict],
                ks: tuple[int, ...] = (1, 2, 3, 4, 5)) -> dict:
    """A queue of batches, one step each: scalar components summed over the
    queue, ``alignment_score`` stacked to ``[Q, B]`` (the outputs of
    ``make_serving_queue``)."""
    step = make_serving_step(model, modules, ks)
    outs = [step(b) for b in batches]
    summed = {}
    for k in outs[0]:
        if k == "alignment_score":
            summed[k] = torch.stack([o[k] for o in outs])
        elif isinstance(outs[0][k], tuple):
            summed[k] = tuple(sum(o[k][i] for o in outs) for i in range(2))
        else:
            summed[k] = sum(o[k] for o in outs)
    return summed
