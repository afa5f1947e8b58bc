"""Data parallel through the port on the CPU: two ranks over gloo.

The two ranks are processes of one module-scoped group
(``parallel.launch.run_ranks``, gloo) that runs every two-rank check of
this file in turn and writes its readings to a file; the tests compare
them with

* the port at dp = 1 on the same batches: each batch is pooled per rank's
  block (``pool_compact_sharded(dp=2)``), and dp = 1 runs that same layout;
* the JAX package's dp = 2 mesh on two of the conftest's virtual CPU
  devices (its ``shard_batch``, GSPMD), from the same float64 weights.

Configurations and tolerances are those of ``tests/test_torch_training.py``
(the point configuration against JAX's plain PointNet: losses rtol 1e-10,
gradients and parameters rtol 1e-9 / atol 1e-12) and of
``tests/test_torch_pct_training.py`` (the pct configuration, the JAX
Pallas kernels in interpret mode, the head's dropout off on both sides:
losses 1e-10, gradients and running statistics 1e-8 / 1e-11, parameters
1e-8 / 1e-9), over three Adam steps on B = 4 pairs (two a rank). The port's
dp = 2 is held to its dp = 1 at the same tolerances, and the two ranks'
parameters and running statistics to the same bits.
"""

import logging
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from sgaligner_tpu.core.config import make_cfg as jax_make_cfg
from sgaligner_tpu.data import batch as JB
from sgaligner_tpu.engine.factory import build_optimizer as jax_build_optimizer
from sgaligner_tpu.engine.train_step import TrainState as JaxTrainState
from sgaligner_tpu.engine.train_step import make_serving_queue as jax_serving_queue
from sgaligner_tpu.engine.train_step import make_train_step as jax_train_step
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu.ops.objective import overall_loss as jax_overall_loss
from sgaligner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sgaligner_tpu.parallel.mesh import replicated
from sgaligner_tpu.parallel.mesh import shard_batch as jax_shard_batch
from sgaligner_tpu.parallel.mesh import shard_queue as jax_shard_queue
from sgaligner_tpu_torch.core import checkpoint as ckpt
from sgaligner_tpu_torch.core.checkpoint import (loss_state_dict_from_flax,
                                                 state_dict_from_flax)
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data import batch as PB
from sgaligner_tpu_torch.data.batch import BatchSpec, to_device
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import (create_train_state, make_train_step,
                                                   serve_queue)
from sgaligner_tpu_torch.engine.trainer import Trainer
from sgaligner_tpu_torch.models.pct import valid_rows
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.ops.objective import OverallLoss
from sgaligner_tpu_torch.ops.pct_attention import BlockResidual
from sgaligner_tpu_torch.ops.pct_tail import PctTail
from sgaligner_tpu_torch.parallel import mesh as PM
from sgaligner_tpu_torch.parallel.launch import run_ranks
from tests.test_torch_model import jax_inputs
from tests.test_torch_ops import expect_dtype

POINT = ("point", "gat", "rel", "attr")
PCT = ("pct", "gat", "rel", "attr")
WIDTHS = dict(pt_out_dim=32, emb_dim=16, hidden_units=(3, 16, 16), heads=(2, 2))
SPEC = BatchSpec(batch_size=4, max_objects=8, points_per_object=32)
BUCKET = {POINT: 8, PCT: 16}
NAMES = {POINT: "point", PCT: "pct"}
DP = 2
STEPS = 3
TOLS = {POINT: {"loss": 1e-10, "grad": (1e-9, 1e-12), "param": (1e-9, 1e-12)},
        PCT: {"loss": 1e-10, "grad": (1e-8, 1e-11), "param": (1e-8, 1e-9),
              "stats": (1e-8, 1e-11)}}
LOSS_KEYS = ("loss", "icl_loss_unimodal", "icl_loss_multimodal", "ial_loss")
# the Trainer builds its model as a user does: parameters and Adam at f32
# (the forward at f64), so a last-bit difference of a summed gradient can
# round an f32 parameter one step apart
TRAINER_TOL = (1e-6, 1e-7)
# the block and tail op check: O objects of P points, C = 128
OP_O, OP_P, OP_C = 8, 16, 128
RANK_TIMEOUT = 240.0
# each rank's torch CPU threads
RANK_THREADS = 2


# ---------------------------------- inputs ----------------------------------

def _host(modules, seed, b=SPEC.batch_size):
    spec = BatchSpec(b, SPEC.max_objects, SPEC.points_per_object)
    raw = make_synthetic_batch(spec, seed=seed, bow_noise=1.0, resample=True)
    return PB.pool_compact_sharded(raw, BUCKET[modules], DP)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_weights(modules, host):
    """Seeded JAX weights at f64 (f32-exact values, non-zero biases and
    fusion weights; pct: running statistics away from 0 / 1)."""
    model = JaxEncoder(modules=modules, pointnet_fused="always" if modules == PCT
                       else "never", dtype=jnp.float64, **WIDTHS)
    with nn.intercept_methods(_no_dropout):
        variables = jax.jit(model.init, static_argnames="train")(
            jax.random.key(0), jax_inputs(host), train=False)
    rng = np.random.default_rng(7)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float64)
        if "bias" in name or "fusion" in name:
            a = a + rng.normal(size=a.shape) * 0.05
        return jnp.asarray(a.astype(np.float32), jnp.float64)

    def stats(path, a):
        name = jax.tree_util.keystr(path)
        a = 0.1 * rng.normal(size=a.shape) if "mean" in name else 0.5 + rng.random(a.shape)
        return jnp.asarray(a.astype(np.float32), jnp.float64)

    params = {"model": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
              "loss": {"ial_log_vars": jnp.asarray([0.1, -0.2, 0.05, 0.0]),
                       "icl_log_vars": jnp.asarray([-0.1, 0.2, 0.0, 0.15])}}
    batch_stats = jax.tree_util.tree_map_with_path(stats, variables.get("batch_stats", {}))
    return model, params, batch_stats


def _op_inputs():
    rng = np.random.default_rng(5)
    c, da = OP_C, OP_C // 4
    t = lambda *shape, s=1.0: torch.from_numpy(rng.normal(size=shape) * s)  # noqa: E731
    mask = torch.ones(OP_O, 1, dtype=torch.float64)
    mask[[2, 5]] = 0.0
    return {"x": t(OP_O, OP_P, c), "wqk": t(c, da, s=c ** -0.5), "wv": t(c, c, s=c ** -0.5),
            "bv": t(c, s=0.1), "wt": t(c, c, s=c ** -0.5), "bt": t(c, s=0.1),
            "bn_scale": 1.0 + t(c, s=0.1), "bn_bias": t(c, s=0.1), "mask": mask,
            "cot": t(OP_O, OP_P, c), "cot_sums": t(2, c),
            "feats": [t(OP_O, OP_P, c) for _ in range(4)], "w": t(4 * c, 1024, s=(4 * c) ** -0.5),
            "cot_pool": t(2, OP_O, 1024), "cot_tail_sums": t(2, 1024)}


# ------------------------------- the port side ------------------------------

def _port_state(modules, weights, dropout=0.0):
    model = MultiModalEncoder(modules, dtype=torch.float64, **WIDTHS).double()
    model.load_state_dict(weights["model"])
    if modules == PCT:
        model.object_encoder.dropout = dropout
    objective = OverallLoss(modules).double()
    objective.load_state_dict(weights["loss"])
    return create_train_state(model, make_cfg(modules=list(modules)), objective)


def _named(state, grads=False):
    pairs = [*state.model.named_parameters(),
             *(("loss." + k, p) for k, p in state.objective.named_parameters())]
    if grads:
        return {k: p.grad.detach().clone() for k, p in pairs}
    out = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    out.update({k: p.detach().clone() for k, p in pairs if k.startswith("loss.")})
    return out


def _port_train(modules, weights, host, mesh, dropout=0.0):
    """Three train steps: the losses, the first step's gradients, the
    parameters and running statistics after the third."""
    state = _port_state(modules, weights, dropout)
    step = make_train_step(modules, mesh)
    batch = to_device(PM.shard_batch(host, mesh), "cpu")
    losses, grads = [], None
    for i in range(STEPS):
        losses.append({k: float(v) for k, v in step(state, batch).items()})
        if i == 0:
            grads = _named(state, grads=True)
    return {"losses": losses, "grads": grads, "params": _named(state),
            "counters": (state.step, state.updates, state.skipped)}


def _block_and_tail(inp, mesh):
    """BlockResidual and PctTail forward and backward, as NaivePCT runs them
    (the tail's sums summed over the ranks after the op), on this rank's
    objects; a seeded cotangent on every output (the whole batch's sums
    take it once: 1/dp a rank). Returns the whole batch's outputs and
    gradients."""
    dp = PM.dp_size(mesh)
    rows = mesh.block(OP_O // dp) if PM.sharded(mesh) else slice(None)
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("wqk", "wv", "bv", "wt", "bt", "bn_scale", "bn_bias", "w")}
    x = inp["x"][rows].clone().requires_grad_(True)
    feats = [f[rows].clone().requires_grad_(True) for f in inp["feats"]]
    mask = inp["mask"][rows]
    count = valid_rows(mask[:, 0], OP_P, mesh)
    x_next, ssum, ssumsq = BlockResidual.apply(
        x, *(leaves[k] for k in ("wqk", "wv", "bv", "wt", "bt", "bn_scale", "bn_bias")),
        mask, count, True, False, 1e-5, mesh)
    pmax, pmin, s1, s2 = PctTail.apply(*feats, leaves["w"], mask)
    s1, s2 = PM.all_reduce_sum(mesh, s1, s2)
    cs, ct = inp["cot_sums"], inp["cot_tail_sums"]
    loss = ((x_next * inp["cot"][rows]).sum() + (pmax * inp["cot_pool"][0][rows]).sum()
            + (pmin * inp["cot_pool"][1][rows]).sum()
            + ((ssum[0] * cs[0]).sum() + (ssumsq[0] * cs[1]).sum()
               + (s1[0] * ct[0]).sum() + (s2[0] * ct[1]).sum()) / dp)
    loss.backward()
    local = PM.gather_rows(mesh, x_next.detach(), pmax.detach(), pmin.detach(), x.grad,
                           *(f.grad for f in feats))
    shared = PM.reduce_sum(mesh, [p.grad for p in leaves.values()])
    out = dict(zip(("x_next", "pmax", "pmin", "dx", "df1", "df2", "df3", "df4"), local))
    out.update(zip((f"d{k}" for k in leaves), shared))
    out.update(ssum=ssum.detach(), ssumsq=ssumsq.detach(), s1=s1.detach(), s2=s2.detach())
    return out


def _nonfinite(weights, good, bad, mesh):
    """A finite step, then one whose batch has a NaN point in rank 1's
    block: the counters and whether the parameters and Adam's state kept
    their bits."""
    state = _port_state(POINT, weights)
    step = make_train_step(POINT, mesh)
    step(state, to_device(PM.shard_batch(good, mesh), "cpu"))
    before = _named(state)
    adam = {k: {n: t.clone() for n, t in v.items()} for k, v in state.optimizer.state.items()}
    out = step(state, to_device(PM.shard_batch(bad, mesh), "cpu"))
    kept = (all(torch.equal(v, before[k]) for k, v in _named(state).items())
            and all(torch.equal(t, adam[k][n]) for k, v in state.optimizer.state.items()
                    for n, t in v.items()))
    return {"loss_finite": bool(torch.isfinite(out["loss"])), "kept": kept,
            "counters": (state.step, state.updates, state.skipped)}


def _queue(weights, stacked, mesh):
    state = _port_state(POINT, weights)
    local = PM.shard_queue(stacked, mesh)
    q = len(local["overlap"])
    batches = [to_device({k: v[i] for k, v in local.items()}, "cpu") for i in range(q)]
    return serve_queue(state.model, POINT, batches, mesh=mesh)


def _trainer_cfg(root, dp, epochs, model_name="sgaligner"):
    model = dict(WIDTHS, hidden_units=list(WIDTHS["hidden_units"]),
                 heads=list(WIDTHS["heads"]), dropout=0.5)
    cfg = make_cfg(seed=42, model_name=model_name, modules=list(POINT), model=model,
                   optim={"max_epoch": epochs},
                   tpu={"max_objects": SPEC.max_objects,
                        "points_per_object": SPEC.points_per_object,
                        "compute_dtype": "float64", "dp": dp})
    cfg.snapshot_dir = cfg.output_dir = cfg.log_dir = root
    os.makedirs(root, exist_ok=True)
    return cfg


def _trainer_runs(batches, root, dp, mesh=None):
    """The Trainer over fixed batches (GAT dropout 0.5): two epochs in one
    run; then in another directory one epoch, and a new Trainer resumed to
    two. The val summaries and the parameters of each."""
    def run(sub, epochs, resume=False):
        cfg = _trainer_cfg(osp.join(root, sub), dp, epochs)
        trainer = Trainer(cfg, lambda: iter(batches["train"]), lambda: iter(batches["val"]),
                          device="cpu")
        trainer.init_state()
        history = trainer.run(resume=resume)["history"]
        logs.extend(h.baseFilename for h in trainer.logger.logger.handlers
                    if isinstance(h, logging.FileHandler))
        return [h["val"] for h in history], _named(trainer.state)

    logs: list[str] = []
    whole_val, whole = run("whole", 2)
    run("split", 1)
    resumed_val, resumed = run("split", 2, resume=True)
    return {"val": whole_val, "params": whole, "resumed_val": resumed_val,
            "resumed": resumed, "logs": logs}


def _raises(fn, *args):
    try:
        fn(*args)
    except (RuntimeError, ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def _ranks(mesh, work):
    """Every two-rank check in turn; the readings go to ``rank<r>.pt``."""
    torch.set_num_threads(RANK_THREADS)
    inp = torch.load(osp.join(work, "inputs.pt"), weights_only=False)
    saved = []
    save = ckpt.save_torch_snapshot

    def counting(path, *args, **kwargs):
        saved.append(osp.basename(path))
        return save(path, *args, **kwargs)

    ckpt.save_torch_snapshot = counting
    try:
        out = {
            "point": _port_train(POINT, inp["weights"][POINT], inp["host"][POINT], mesh),
            "pct": _port_train(PCT, inp["weights"][PCT], inp["host"][PCT], mesh),
            "pct_dropout": _port_train(PCT, inp["weights"][PCT], inp["host"][PCT], mesh,
                                       dropout=0.5),
            "ops": _block_and_tail(inp["ops"], mesh),
            "nonfinite": _nonfinite(inp["weights"][POINT], inp["host"][POINT],
                                    inp["bad"], mesh),
            "queue": _queue(inp["weights"][POINT], inp["stacked"], mesh),
            "trainer": _trainer_runs(inp["trainer"], osp.join(work, "trainer"), DP),
        }
    finally:
        ckpt.save_torch_snapshot = save
    out["saved"] = saved
    out["raises"] = {
        "dp 3 on 2 ranks": _raises(PM.make_mesh, 3),
        "dp 1 on 2 ranks": _raises(PM.make_mesh, 1),
        "eva": _raises(Trainer, _trainer_cfg(osp.join(work, "eva"), DP, 1, "eva"),
                       lambda: iter(()), None, False, None, None, "cpu"),
    }
    torch.save(out, osp.join(work, f"rank{mesh.rank}.pt"))


# -------------------------------- the JAX side ------------------------------

def _jax_train(modules, model, params, batch_stats, host):
    """JAX's dp = 2 mesh: the first step's gradients, three train steps."""
    mesh = jax_make_mesh(DP)
    rep = replicated(mesh)
    jb = jax_shard_batch(jax_inputs(host), mesh)
    params_r, stats_r = jax.device_put((params, batch_stats), rep)

    def loss_fn(p):
        variables = {"params": p["model"]}
        kw = {}
        if batch_stats:
            variables["batch_stats"] = stats_r
            kw["mutable"] = ["batch_stats"]
        out = model.apply(variables, jb, train=True, rngs={"dropout": jax.random.key(2)},
                          **kw)
        embs = out[0] if batch_stats else out
        return jax_overall_loss(embs, jb, p["loss"], modules)["loss"]

    tx = jax_build_optimizer(jax_make_cfg(modules=list(modules)))
    state = jax.device_put(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.copy, params),
        opt_state=tx.init(params), batch_stats=jax.tree.map(jnp.copy, batch_stats),
        rng=jax.random.key(1)), rep)
    step = jax_train_step(model, tx, modules)
    with nn.intercept_methods(_no_dropout):
        grads = jax.jit(jax.grad(loss_fn))(params_r)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, jb)
            losses.append({k: float(expect_dtype(v)) for k, v in metrics.items()})
    return {"losses": losses, "grads": _flax_named(modules, grads, batch_stats, False),
            "params": _flax_named(modules, jax.tree.map(np.asarray, state.params),
                                  jax.tree.map(np.asarray, state.batch_stats))}


def _flax_named(modules, tree, batch_stats, with_stats=True):
    expect_dtype([tree, batch_stats], what="JAX parameters / gradients / stats")
    out = {k: v for k, v in state_dict_from_flax(tree["model"], batch_stats,
                                                 modules).items()
           if with_stats or "running_" not in k}
    out.update({f"loss.{k}": v for k, v in loss_state_dict_from_flax(tree["loss"]).items()})
    return out


def _jax_queue(model, params, stacked):
    mesh = jax_make_mesh(DP)
    jq = jax_shard_queue({k: jnp.asarray(v) for k, v in stacked.items()}, mesh)
    return jax_serving_queue(model, POINT)(jax.device_put(params, replicated(mesh)), {}, jq)


# --------------------------------- the group --------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks (started first, in the background), the port at
    dp = 1 and the JAX dp = 2 mesh on the same inputs."""
    work = str(tmp_path_factory.mktemp("dp2"))
    host = {m: _host(m, 3) for m in (POINT, PCT)}
    bad = {k: v.copy() for k, v in host[POINT].items()}
    k = bad["pooled_mask"].shape[0] // DP
    bad["obj_points_pooled"][k + np.flatnonzero(bad["pooled_mask"][k:])[0], 0, 0] = np.nan
    queue = [_host(POINT, 50 + i) for i in range(2)]
    stacked = PB.stack_queue(queue, dp=DP)
    trainer_batches = {"train": [_host(POINT, 60 + i) for i in range(3)],
                       "val": [_host(POINT, 70, b=4), _host(POINT, 71, b=3)]}

    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        jax_models, weights = {}, {}
        for m in (POINT, PCT):
            jax_models[m] = _jax_weights(m, host[m])
            _, params, stats = jax_models[m]
            weights[m] = {"model": state_dict_from_flax(params["model"], stats, m),
                          "loss": loss_state_dict_from_flax(params["loss"])}
        torch.save({"weights": weights, "host": host, "bad": bad, "stacked": stacked,
                    "ops": _op_inputs(), "trainer": trainer_batches},
                   osp.join(work, "inputs.pt"))
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, _ranks, DP, "gloo", work, timeout=RANK_TIMEOUT)
            one = {NAMES[m]: _port_train(m, weights[m], host[m], None) for m in (POINT, PCT)}
            one["pct_dropout"] = _port_train(PCT, weights[PCT], host[PCT], None, dropout=0.5)
            one["ops"] = _block_and_tail(_op_inputs(), None)
            one["nonfinite"] = _nonfinite(weights[POINT], host[POINT], bad, None)
            one["queue"] = _queue(weights[POINT], stacked, None)
            one["trainer"] = _trainer_runs(trainer_batches, osp.join(work, "one"), 1)
            jx = {NAMES[m]: _jax_train(m, *jax_models[m], host[m]) for m in (POINT, PCT)}
            jx["queue"] = _jax_queue(jax_models[POINT][0], jax_models[POINT][1], stacked)
            ranks.result()
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()
    two = [torch.load(osp.join(work, f"rank{r}.pt"), weights_only=False) for r in range(DP)]
    return {"one": one, "two": two, "jax": jx}


def _close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=tol[0],
                                   atol=tol[1], err_msg=f"{what}: {k}")


def _losses_close(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"{what} step {i}: {k}")


def _bit_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


# ---------------------------------- tests -----------------------------------

@pytest.mark.parametrize("dp", [1, 2, 4])
def test_batch_copies_match_jax(dp):
    """pad_batch_to, pool_compact_sharded and stack_queue are array-equal
    to the JAX package's (B = 6 does not split over 4: padded)."""
    spec = BatchSpec(batch_size=6, max_objects=6, points_per_object=16)
    raws = [make_synthetic_batch(spec, seed=s) for s in (1, 2)]
    raws[1]["obj_mask"][:, 4:6] = False
    raws[1]["obj_mask"][:, 10:] = False
    for raw in raws:
        for target in (6, 8):
            got, want = PB.pad_batch_to(raw, target), JB.pad_batch_to(raw, target)
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = [PB.pool_compact_sharded(r, bucket=4, dp=dp) for r in raws]
    want = [JB.pool_compact_sharded(r, bucket=4, dp=dp) for r in raws]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)
    q_got, q_want = PB.stack_queue(got, dp=dp), JB.stack_queue(want, dp=dp)
    assert sorted(q_got) == sorted(q_want)
    for key in q_want:
        np.testing.assert_array_equal(q_got[key], q_want[key], err_msg=key)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_batch_blocks(dp):
    """Each rank's block: its pairs, its pooled rows with local flat
    indices (masked rows at 0), which scatter back to the whole batch's
    slots; rows pooled for one rank raise under dp > 1; an unpooled batch
    is padded to a multiple of dp; a pair over the compaction bound
    raises."""
    spec = BatchSpec(batch_size=6, max_objects=6, points_per_object=16)
    batch = PB.pool_compact_sharded(make_synthetic_batch(spec, seed=3), bucket=4, dp=dp)
    b, two_n = batch["obj_mask"].shape
    raw = PB.pad_batch_to(make_synthetic_batch(spec, seed=3), b)
    rows = np.zeros((b * two_n,), np.int64)
    for r in range(dp):
        mesh = PM.Mesh(dp, r) if dp > 1 else None
        local = PM.shard_batch(batch, mesh)
        bs = b // dp
        np.testing.assert_array_equal(local["e1i"], batch["e1i"][r * bs:(r + 1) * bs])
        m = local["pooled_mask"]
        assert (local["pooled_flat_idx"][~m] == 0).all()
        idx = local["pooled_flat_idx"][m]
        assert ((idx >= 0) & (idx < bs * two_n)).all()
        np.add.at(rows, idx + r * bs * two_n, 1)
        np.testing.assert_array_equal(
            local["obj_points_pooled"][m],
            raw["obj_points"].reshape((b * two_n,) + raw["obj_points"].shape[2:])[
                idx + r * bs * two_n])
    np.testing.assert_array_equal(rows, raw["obj_mask"].reshape(-1))
    PM.validate_compact_bound(raw, 2 * spec.max_objects)
    with pytest.raises(ValueError, match="compact_slots"):
        PM.validate_compact_bound(raw, 3)
    if dp > 1:
        # pooled for one rank: pair 0 holds one object, so rank 0's rows
        # reach into pair 1
        lone = make_synthetic_batch(BatchSpec(2, 6, 16), seed=5)
        lone["obj_mask"][0, 1:] = False
        with pytest.raises(ValueError, match="another rank"):
            PM.shard_batch(PB.pool_compact(lone, 4), PM.Mesh(2, 0))
        unpooled = PM.shard_batch(make_synthetic_batch(
            BatchSpec(5, 6, 16), seed=4), PM.Mesh(dp, dp - 1))
        assert unpooled["obj_mask"].shape[0] == -(-5 // dp)


@pytest.mark.parametrize("modules", [POINT, PCT], ids=["point", "pct"])
def test_train_steps_dp2_match_dp1_and_jax(runs, modules):
    """Losses of three steps, the first step's gradients, the parameters
    and running statistics after the third: rank 0 at dp = 2 against the
    port at dp = 1 and against the JAX dp = 2 mesh; rank 1 bit-equal to
    rank 0."""
    tol, name = TOLS[modules], NAMES[modules]
    two, one, jx = runs["two"][0][name], runs["one"][name], runs["jax"][name]
    for want, who in ((one, "port dp=1"), (jx, "JAX dp=2")):
        _losses_close(two["losses"], want["losses"], tol["loss"], who)
        _close(two["grads"], want["grads"], tol["grad"], f"gradients vs {who}")
        params = {k: v for k, v in want["params"].items() if "running_" not in k}
        stats = {k: v for k, v in want["params"].items() if "running_" in k}
        _close({k: two["params"][k] for k in params}, params, tol["param"],
               f"parameters vs {who}")
        _close({k: two["params"][k] for k in stats}, stats, tol.get("stats"),
               f"running statistics vs {who}")
        assert bool(stats) == (modules == PCT)
    assert two["losses"][-1]["loss"] < two["losses"][0]["loss"]
    assert two["counters"] == one["counters"] == (STEPS, STEPS, 0)
    _bit_equal(runs["two"][1][name]["params"], two["params"], "rank 1 vs rank 0")


def test_head_dropout_dp2_matches_dp1(runs):
    """NaivePCT's head dropout at 0.5: each rank keeps its rows of the whole
    batch's masks, so dp = 2 is dp = 1 with the same generator."""
    tol = TOLS[PCT]
    two, one = runs["two"][0]["pct_dropout"], runs["one"]["pct_dropout"]
    _losses_close(two["losses"], one["losses"], tol["loss"], "dropout 0.5")
    _close(two["grads"], one["grads"], tol["grad"], "gradients, dropout 0.5")
    assert abs(two["losses"][0]["loss"] - runs["one"]["pct"]["losses"][0]["loss"]) > 1e-3
    _bit_equal(runs["two"][1]["pct_dropout"]["params"], two["params"], "rank 1 vs rank 0")


def test_block_residual_and_tail_dp2_match_dp1(runs):
    """BlockResidual and PctTail forward and backward: the whole batch's
    outputs, the gathered input gradients and the summed weight gradients
    at dp = 2 equal dp = 1's."""
    one = runs["one"]["ops"]
    for r in range(DP):
        two = runs["two"][r]["ops"]
        _close(two, one, (1e-12, 1e-13), f"rank {r}")
    assert float(one["dbn_scale"].abs().max()) > 0 and float(one["dx"].abs().max()) > 0


def test_nonfinite_shard_makes_every_rank_skip(runs):
    """A NaN point in rank 1's block: both ranks keep their parameters and
    Adam's state and count one skipped step, as dp = 1 does."""
    one = runs["one"]["nonfinite"]
    assert not one["loss_finite"] and one["kept"] and one["counters"] == (2, 1, 1)
    for r in range(DP):
        assert runs["two"][r]["nonfinite"] == one, r


def test_serving_queue_dp2_matches_dp1_and_jax(runs):
    """The queue of two per-block pooled batches, the pair axis split over
    the ranks: counts exact, rr_sum and alignment_score to 1e-9 (the JAX
    queue of tests/test_serving.py:74 on a dp = 2 mesh)."""
    one, jx = runs["one"]["queue"], runs["jax"]["queue"]
    for r in range(DP):
        two = runs["two"][r]["queue"]
        for want in (one, {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                               else np.asarray(v)) for k, v in jx.items()}):
            assert int(two["rr_count"]) == int(want["rr_count"]) > 0
            np.testing.assert_allclose(float(two["rr_sum"]), float(want["rr_sum"]),
                                       rtol=1e-9)
            np.testing.assert_allclose(np.asarray(two["alignment_score"]),
                                       np.asarray(want["alignment_score"]), rtol=1e-9)
            for k in (1, 2, 3, 4, 5):
                assert [int(x) for x in two[f"hits@{k}"]] == \
                    [int(x) for x in want[f"hits@{k}"]], k
        assert tuple(two["alignment_score"].shape) == (2, SPEC.batch_size)


def test_trainer_dp2(runs):
    """Two epochs through the Trainer at dp = 2: rank 0 alone writes the
    snapshots and the log, the val metrics and parameters equal dp = 1's,
    and a run resumed after one epoch equals the uninterrupted run."""
    one = runs["one"]["trainer"]
    zero, first = runs["two"]
    assert first["saved"] == [] and first["trainer"]["logs"] == []
    assert len(zero["trainer"]["logs"]) == 3 and "best_snapshot.pth.tar" in zero["saved"]
    assert zero["saved"].count("snapshot.pth.tar") == 4     # 2 + 1 + 1 epochs
    for r, two in enumerate(runs["two"]):
        t = two["trainer"]
        for got, want in zip(t["val"], one["val"], strict=True):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12,
                                           err_msg=f"rank {r}: val {k}")
        _close(t["params"], one["params"], TRAINER_TOL, f"rank {r}: parameters")
        _bit_equal(t["resumed"], t["params"], f"rank {r}: resumed")
        assert t["resumed_val"] == t["val"][1:]
    _bit_equal(runs["two"][1]["trainer"]["params"], zero["trainer"]["params"],
               "rank 1 vs rank 0")


def test_dp_must_match_the_ranks(runs, tmp_path):
    """A tpu.dp the process group disagrees with raises, dp > 1 without a
    process group raises, and EVA's training under dp raises naming its
    ROADMAP item."""
    for r in range(DP):
        raised = runs["two"][r]["raises"]
        assert raised["dp 3 on 2 ranks"].startswith("ValueError"), raised
        assert raised["dp 1 on 2 ranks"].startswith("ValueError"), raised
        assert raised["eva"].startswith("NotImplementedError") and "item 8" in raised["eva"]
    with pytest.raises(RuntimeError, match="process group"):
        PM.make_mesh(2)
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(_trainer_cfg(str(tmp_path), 2, 1), lambda: iter(()), device="cpu")
    assert PM.make_mesh(0) == PM.make_mesh(1) == PM.Mesh()
