"""Train, eval and serving steps.

Counterpart of ``sgaligner_tpu/engine/train_step.py``: ``TrainState``,
``create_train_state``, ``make_train_step`` (forward, the objective,
backward, Adam with gradient accumulation and the non-finite skip),
``make_eval_step`` (loss, ranks, MRR / Hits@K components, SGAR,
``alignment_score``), ``eval_epoch`` (a pass of it) and the serving steps
(``make_serving_step``, ``serve_queue``; ``serving_metrics`` and
``queue_metrics`` are their bodies, which ``serving.py`` exports). The JAX steps take parameter trees
and return new ones; here the model and the objective hold their
parameters, the train step updates them in place, and every step takes the
batch as a dict of tensors on the model's device (``data.batch.to_device``).

Data parallel: a step made with a ``mesh`` (``parallel.mesh``) takes this
rank's block of the batch (``shard_batch``, then ``to_device``) and is the
one-rank step on the whole batch. The train step gathers every rank's
embeddings and the objective's batch fields, computes the whole batch's
loss on each rank, back-propagates 1/dp of it and sums the gradients over
the ranks before the finite check and Adam, so every rank takes the same
update (or skips the same step). The eval and serving steps sum the metric
components over the ranks and gather the per-pair outputs in pair order.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.data.batch import to_device
from sgaligner_tpu_torch.engine.factory import build_lr_schedule, build_optimizer
from sgaligner_tpu_torch.ops import metrics as M
from sgaligner_tpu_torch.ops.objective import OverallLoss
from sgaligner_tpu_torch.parallel.mesh import (Mesh, gather_rows, reduce_sum,
                                               shard_batch, sharded)

# the batch fields the objectives read (``ops.objective.flat_loss_indices``)
LOSS_FIELDS = ("obj_mask", "e1i", "e2i", "anchor_mask", "e1j", "e1j_mask", "e2j",
               "e2j_mask")


def gather_embeddings(mesh: Mesh | None, embs: dict) -> dict:
    """Every rank's embeddings (flat ``[b·2N, D]``) in pair order, on every
    rank; differentiable."""
    if not sharded(mesh):
        return embs
    return dict(zip(embs, gather_rows(mesh, *embs.values())))


def gather_batch(mesh: Mesh | None, batch: dict) -> dict:
    """The whole batch's ``LOSS_FIELDS`` from every rank's block."""
    if not sharded(mesh):
        return batch
    return dict(zip(LOSS_FIELDS, gather_rows(mesh, *(batch[k] for k in LOSS_FIELDS))))


@dataclass
class TrainState:
    """``updates`` counts the optimizer updates applied, which is the
    schedule's count; a skipped non-finite step advances ``skipped`` but not
    ``updates`` or Adam's state. With ``acc_steps`` > 1 (``optim.
    grad_acc_steps``) a finite step adds its gradient to ``acc``, the
    running mean of optax ``MultiSteps``, and every ``acc_steps``-th one
    applies it; ``mini`` counts the steps in ``acc``. ``step`` counts every
    call of the train step, as the JAX state's does."""

    model: torch.nn.Module
    objective: OverallLoss
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    generator: torch.Generator      # dropout masks, on the model's device
    acc_steps: int = 1
    updates: int = 0
    skipped: int = 0
    mini: int = 0
    acc: list[torch.Tensor] | None = None

    @property
    def step(self) -> int:
        return self.updates * self.acc_steps + self.mini + self.skipped

    def parameters(self) -> list[torch.nn.Parameter]:
        return [*self.model.parameters(), *self.objective.parameters()]

    def state_dict(self) -> dict:
        """Everything but the model's weights that a resumed run needs: the
        objective's parameters, Adam's state, the dropout generator's state,
        the counters and the accumulated gradient (the JAX rolling
        snapshot's ``opt_state``, ``rng`` and ``step``), on the CPU."""
        return {"objective": {k: v.detach().cpu()
                              for k, v in self.objective.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
                "updates": self.updates, "skipped": self.skipped, "mini": self.mini,
                "acc": None if self.acc is None else [a.cpu() for a in self.acc]}

    def load_state_dict(self, blob: dict) -> None:
        """The inverse of ``state_dict`` (tensors go to the parameters'
        devices)."""
        self.objective.load_state_dict(blob["objective"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.generator.set_state(blob["generator"])
        self.updates, self.skipped, self.mini = (int(blob[k]) for k in
                                                 ("updates", "skipped", "mini"))
        self.acc = (None if blob["acc"] is None else
                    [a.to(p.device) for a, p in zip(blob["acc"], self.parameters())])


def create_train_state(model, cfg: Config, objective: OverallLoss | None = None
                       ) -> TrainState:
    """Objective (log-variances at zero), Adam over model and objective
    parameters, and a dropout generator seeded from ``cfg.seed`` on the
    model's device; ``cfg.optim.grad_acc_steps`` steps to an update."""
    device = next(model.parameters()).device
    if objective is None:
        objective = OverallLoss(model.modal_names, zoom=cfg.loss.zoom)
    objective = objective.to(device)
    params = [*model.parameters(), *objective.parameters()]
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return TrainState(model=model, objective=objective,
                      optimizer=build_optimizer(cfg, params),
                      schedule=build_lr_schedule(cfg), generator=generator,
                      acc_steps=max(cfg.optim.grad_acc_steps, 1))


def _update(state: TrainState) -> None:
    """One Adam update from the parameters' ``.grad`` at the schedule's
    rate."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.updates)
    state.optimizer.step()
    state.updates += 1


def _accumulate(state: TrainState, params: list[torch.nn.Parameter]) -> None:
    """optax ``MultiSteps``: ``acc + (g - acc) / (mini + 1)``; on the
    ``acc_steps``-th step the mean becomes the gradient of one update and
    the accumulator starts again from zero."""
    if state.acc is None:
        state.acc = [torch.zeros_like(p) for p in params]
    for a, p in zip(state.acc, params):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        a.add_((g - a) / (state.mini + 1))
    state.mini += 1
    if state.mini < state.acc_steps:
        return
    for a, p in zip(state.acc, params):
        p.grad = a.clone()
        a.zero_()
    state.mini = 0
    _update(state)


def make_train_step(modules: tuple[str, ...], mesh: Mesh | None = None):
    """Returns ``step(state, batch) -> losses``: ``loss`` and its terms
    (``icl_loss_unimodal``, ``icl_loss_multimodal``, ``ial_loss`` for
    ``OverallLoss``; one NCA term per head for ``OverallNCALoss``;
    detached; the whole batch's under data parallel). The step is dropped
    whole when any gradient is non-finite (optax ``apply_if_finite`` around
    ``MultiSteps``): parameters, Adam's state and the accumulated gradient
    stay as they were. Deciding that reads one flag back from the device per
    step; under data parallel it reads the gradients summed over the ranks,
    the same on every rank, so the ranks decide alike. BatchNorm running
    statistics move in the forward, on a skipped step too, as the JAX step
    assigns the new ``batch_stats`` either way."""

    def step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        if tuple(modules) != state.objective.modal_names:
            raise ValueError(f"objective modules {state.objective.modal_names} "
                             f"!= {tuple(modules)}")
        state.model.train(True)
        state.optimizer.zero_grad(set_to_none=True)
        embs = state.model(batch, generator=state.generator, mesh=mesh)
        losses = state.objective(gather_embeddings(mesh, embs), gather_batch(mesh, batch))
        if sharded(mesh):
            (losses["loss"] / mesh.dp).backward()
        else:
            losses["loss"].backward()
        params = state.parameters()
        grads = [p.grad for p in params if p.grad is not None]
        if sharded(mesh):
            for g, total in zip(grads, reduce_sum(mesh, grads)):
                g.copy_(total)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if not bool(finite):
            state.skipped += 1
        elif state.acc_steps > 1:
            _accumulate(state, params)
        else:
            _update(state)
        return {k: v.detach() for k, v in losses.items()}

    return step


def _rank_metrics(embs, modules, ks, batch, with_sim=False, eval_extras=False,
                  mesh=None):
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
    return _reduce_metrics(mesh, out)


def _reduce_metrics(mesh: Mesh | None, out: dict) -> dict:
    """One rank's metric components -> the whole batch's: the counts and
    sums summed over the ranks, the per-pair outputs (``alignment_score``,
    ``pair_valid``, ``sgar``, ``sim``) gathered in pair order."""
    if not sharded(mesh):
        return out
    hits = [k for k in out if k.startswith("hits@")]
    parts = [out["rr_sum"], out["rr_count"], *(t for k in hits for t in out[k])]
    total = iter(reduce_sum(mesh, parts))
    red = {"rr_sum": next(total), "rr_count": next(total)}
    for k in hits:
        red[k] = (next(total), next(total))
    per_pair = {k: out[k] for k in ("alignment_score", "pair_valid", "sim") if k in out}
    if "sgar" in out:
        per_pair.update({f"sgar/{m}": v for m, v in out["sgar"].items()})
    for k, v in zip(per_pair, gather_rows(mesh, *per_pair.values())):
        if k.startswith("sgar/"):
            red.setdefault("sgar", {})[k[5:]] = v
        else:
            red[k] = v
    return red


def serving_metrics(model, modules: tuple[str, ...], ks: tuple[int, ...],
                    batch: dict, with_sim: bool = False,
                    mesh: Mesh | None = None) -> dict:
    """One batch: the metric components the host accumulates (with
    ``with_sim`` also the per-pair similarity matrices ``sim``); under data
    parallel ``batch`` is this rank's block and the components the whole
    batch's."""
    return _rank_metrics(model(batch, mesh=mesh), modules, ks, batch, with_sim=with_sim,
                         mesh=mesh)


def make_serving_step(model, modules: tuple[str, ...],
                      ks: tuple[int, ...] = (1, 2, 3, 4, 5),
                      with_sim: bool = False, mesh: Mesh | None = None):
    """Returns ``step(batch) -> metric components`` (inference mode; puts
    the model in eval mode)."""

    @torch.inference_mode()
    def step(batch: dict) -> dict:
        model.train(False)
        return serving_metrics(model, modules, ks, batch, with_sim, mesh)

    return step


def make_eval_step(model, objective: OverallLoss, modules: tuple[str, ...],
                   ks: tuple[int, ...] = (1, 2, 3, 4, 5),
                   with_sim: bool = False, mesh: Mesh | None = None):
    """Returns ``step(batch) -> metric components``: ``loss``, ``rr_sum``,
    ``rr_count``, ``pair_valid``, ``sgar`` ({mode: [B]}),
    ``alignment_score``, ``hits@k`` and, with ``with_sim``, the per-pair
    similarity matrices ``sim``; the whole batch's under data parallel."""

    @torch.inference_mode()
    def step(batch: dict) -> dict:
        model.train(False)
        embs = model(batch, mesh=mesh)
        out = {"loss": objective(gather_embeddings(mesh, embs),
                                 gather_batch(mesh, batch))["loss"]}
        out.update(_rank_metrics(embs, modules, ks, batch, with_sim=with_sim,
                                 eval_extras=True, mesh=mesh))
        return out

    return step


def eval_epoch(step, batches, ks: tuple[int, ...], device,
               visit: Callable[[dict, dict], None] | None = None,
               mesh: Mesh | None = None) -> dict[str, float]:
    """One pass of an eval step (``make_eval_step``) over host batches, each
    moved to ``device`` (this rank's block of it under data parallel: the
    step's ``mesh``) and its components read back: ``loss`` (the mean
    over batches), ``last_batch_loss``, ``mrr``, ``hits@k`` and
    ``sgar@{2,50,100}`` over the pass (the JAX trainer's
    ``inference_epoch`` and tester's aggregation), the same on every rank.
    ``visit(batch, out)``, where given, sees each host batch with its
    step's outputs."""
    rr_sum = rr_count = n_pairs = 0.0
    hits = {k: [0.0, 0.0] for k in ks}
    sgar_sums = {"2": 0.0, "50": 0.0, "100": 0.0}
    losses: list[float] = []
    for batch in batches:
        out = step(to_device(shard_batch(batch, mesh), device))
        if visit is not None:
            visit(batch, out)
        losses.append(float(out["loss"]))
        rr_sum += float(out["rr_sum"])
        rr_count += float(out["rr_count"])
        for k in ks:
            c, t = out[f"hits@{k}"]
            hits[k][0] += float(c)
            hits[k][1] += float(t)
        pv = out["pair_valid"]
        n_pairs += float(pv.sum())
        for mode in sgar_sums:
            sgar_sums[mode] += float((out["sgar"][mode] * pv).sum())
    results = {"loss": sum(losses) / len(losses) if losses else float("nan"),
               "last_batch_loss": losses[-1] if losses else float("nan"),
               "mrr": rr_sum / max(rr_count, 1.0)}
    for k in ks:
        results[f"hits@{k}"] = hits[k][0] / max(hits[k][1], 1.0)
    for mode, total in sgar_sums.items():
        results[f"sgar@{mode}"] = total / max(n_pairs, 1.0)
    return results


def queue_metrics(model, modules: tuple[str, ...], ks: tuple[int, ...],
                  batches: list[dict], mesh: Mesh | None = None) -> dict:
    """``serving_metrics`` of each batch in turn: scalar components summed
    over the queue in its order, ``alignment_score`` stacked to ``[Q, B]``
    (the outputs of the JAX ``make_serving_queue``). Under data parallel
    each batch is this rank's block (``parallel.mesh.shard_queue``) and the
    outputs are the whole queue's."""
    outs = [serving_metrics(model, modules, ks, b, mesh=mesh) for b in batches]
    summed = {}
    for k in outs[0]:
        if k == "alignment_score":
            summed[k] = torch.stack([o[k] for o in outs])
        elif isinstance(outs[0][k], tuple):
            summed[k] = tuple(sum(o[k][i] for o in outs) for i in range(2))
        else:
            summed[k] = sum(o[k] for o in outs)
    return summed


def serve_queue(model, modules: tuple[str, ...], batches: list[dict],
                ks: tuple[int, ...] = (1, 2, 3, 4, 5), mesh: Mesh | None = None) -> dict:
    """A queue of batches through ``queue_metrics`` (inference mode; puts
    the model in eval mode)."""
    model.train(False)
    with torch.inference_mode():
        return queue_metrics(model, modules, ks, batches, mesh)
