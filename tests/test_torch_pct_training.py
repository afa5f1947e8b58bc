"""The port's pct-config training slice against the JAX package, at float64
on the CPU.

The JAX model is ``MultiModalEncoder(('pct','gat','rel','attr'),
dtype=float64)`` with the JAX ``build_optimizer`` (Adam, L2 decay,
``apply_if_finite``) and ``make_train_step``; both sides start from the same
float64 weights and running statistics, carried across by
``state_dict_from_flax``. NaivePCT's widths are fixed (128 / 1024 / 512);
the rest is cut (pt_out_dim 32, emb_dim 16, GAT 3 -> 16 -> 16 with 2 heads,
B=2 pairs of 8 + 8 slots, P=32 points, pooled bucket 16, so the encoder sees
O=32 objects and every JAX tile picker takes its kernel). The JAX side runs
with ``pointnet_fused='always'`` (the Pallas embedding, block-forward and
tail kernels in interpret mode, at f64; the block backward through its
pure-JAX fallback) and ``'never'`` (JAX's plain composition).

Dropout: NaivePCT's head hard-codes ``Dropout(0.5)``, whose JAX masks no
torch generator can reproduce. This file alone turns it off on both sides: a
``flax.linen.intercept_methods`` interceptor returns every ``nn.Dropout``'s
input on the JAX side (the JAX package is untouched), and the port model's
head rate is set to 0. ``test_head_dropout_in_train_mode`` checks the port's
dropout by itself.

Tolerances: both sides run the same f64 arithmetic in another summation
order, through four BatchNorm'd attention blocks whose batch statistics
feed back into every gradient. Losses rtol 1e-10; gradients, running
statistics and the eval step's similarities rtol 1e-8 / atol 1e-11; the
parameters after two Adam steps rtol 1e-8 / atol 1e-9: the SA blocks' trans
biases sit right before a batch-statistics BatchNorm, so their gradient is
zero up to rounding (~1e-15), and Adam (m / (sqrt(v) + 1e-8)) turns that
rounding into steps of ~1e-10 that differ between the two sides (measured
4.5e-11).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
from sgaligner_tpu.core.config import make_cfg as jax_make_cfg
from sgaligner_tpu.engine.factory import build_optimizer as jax_build_optimizer
from sgaligner_tpu.engine.train_step import TrainState as JaxTrainState
from sgaligner_tpu.engine.train_step import make_eval_step as jax_eval_step
from sgaligner_tpu.engine.train_step import make_train_step as jax_train_step
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu.ops.objective import overall_loss as jax_overall_loss
from sgaligner_tpu_torch.core.checkpoint import (loss_state_dict_from_flax,
                                                 state_dict_from_flax)
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import (create_train_state,
                                                   make_eval_step, make_train_step)
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.ops.objective import OverallLoss
from tests.test_torch_model import jax_inputs
from tests.test_torch_ops import expect_dtype

MODULES = ("pct", "gat", "rel", "attr")
WIDTHS = dict(pt_out_dim=32, emb_dim=16, hidden_units=(3, 16, 16), heads=(2, 2))
SPEC = BatchSpec(batch_size=2, max_objects=8, points_per_object=32)
BUCKET = 16
LOSS_RTOL = 1e-10
TOL = (1e-8, 1e-11)
PARAM_TOL = (1e-8, 1e-9)
LOSS_KEYS = ("loss", "icl_loss_unimodal", "icl_loss_multimodal", "ial_loss")


def _batch(seed, nan_attr=False):
    host = make_synthetic_batch(SPEC, seed=seed, bow_noise=1.0, resample=True)
    if nan_attr:
        host["bow_attr"][0, host["e1i"][0, 0], 0] = np.nan
    return pool_compact(host, BUCKET)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_side(request):
    """x64 while it lives; the JAX model, weights, running statistics,
    optimizer and jitted steps built once per JAX kernel mode. Every JAX
    trace runs under the dropout interceptor."""
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        with nn.intercept_methods(_no_dropout):
            model = JaxEncoder(modules=MODULES, pointnet_fused=request.param,
                               dtype=jnp.float64, **WIDTHS)
            host = _batch(3)
            assert host["obj_points_pooled"].shape[0] % BUCKET == 0
            variables = jax.jit(model.init, static_argnames="train")(
                jax.random.key(0), jax_inputs(host), train=False)
        rng = np.random.default_rng(7)

        def perturb(path, a):
            # float32-exact values (the port's parameters are loaded from
            # them), non-zero biases and fusion weights
            name = jax.tree_util.keystr(path)
            a = np.asarray(a, np.float64)
            if "bias" in name or "fusion" in name:
                a = a + rng.normal(size=a.shape) * 0.05
            return jnp.asarray(a.astype(np.float32), jnp.float64)

        def stats(path, a):
            name = jax.tree_util.keystr(path)
            a = (0.1 * rng.normal(size=a.shape) if "mean" in name
                 else 0.5 + rng.random(a.shape))
            return jnp.asarray(a.astype(np.float32), jnp.float64)

        params = {
            "model": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
            "loss": {"ial_log_vars": jnp.asarray([0.1, -0.2, 0.05, 0.0]),
                     "icl_log_vars": jnp.asarray([-0.1, 0.2, 0.0, 0.15])},
        }
        batch_stats = jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])
        tx = jax_build_optimizer(jax_make_cfg(modules=list(MODULES)))
        yield {"fused": request.param, "model": model, "params": params,
               "batch_stats": batch_stats, "tx": tx,
               "train_step": jax_train_step(model, tx, MODULES),
               "eval_step": jax_eval_step(model, MODULES, with_sim=True)}
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


def _jax_state(side):
    # the jitted step donates its state: start from copies
    params = jax.tree.map(jnp.copy, side["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=side["tx"].init(params),
                         batch_stats=jax.tree.map(jnp.copy, side["batch_stats"]),
                         rng=jax.random.key(1))


def _port_state(side):
    model = MultiModalEncoder(MODULES, dtype=torch.float64, **WIDTHS).double()
    model.load_state_dict(state_dict_from_flax(side["params"]["model"],
                                               side["batch_stats"], MODULES))
    model.object_encoder.dropout = 0.0
    objective = OverallLoss(MODULES).double()
    objective.load_state_dict(loss_state_dict_from_flax(side["params"]["loss"]))
    return create_train_state(model, make_cfg(modules=list(MODULES)), objective)


def _named(model, objective=None, grads=False):
    out = ({k: p.grad.clone() for k, p in model.named_parameters()} if grads else
           {k: v.detach().clone() for k, v in model.state_dict().items()})
    if objective is not None:
        out.update({f"loss.{k}": (p.grad if grads else p).detach().clone()
                    for k, p in objective.named_parameters()})
    return out


def _flax_named(tree, batch_stats, with_stats=True):
    """A JAX {"model", "loss"} tree (parameters or gradients) under the
    port's names; with_stats adds the running statistics of batch_stats."""
    expect_dtype([tree, batch_stats], what="JAX parameters / gradients / stats")
    out = {k: v for k, v in state_dict_from_flax(tree["model"], batch_stats,
                                                 MODULES).items()
           if with_stats or "running_" not in k}
    out.update({f"loss.{k}": v
                for k, v in loss_state_dict_from_flax(tree["loss"]).items()})
    return out


def _assert_named_close(got, want, what, tol=TOL):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=f"{what}: {k}")


def _jax_loss_grads(side, jb):
    def loss_fn(params):
        embs, _ = side["model"].apply(
            {"params": params["model"], "batch_stats": side["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.key(2)})
        return jax_overall_loss(embs, jb, params["loss"], MODULES)["loss"]

    with nn.intercept_methods(_no_dropout):
        return jax.jit(jax.grad(loss_fn))(side["params"])


# ------------------------------- train steps --------------------------------

@pytest.mark.parametrize("jax_side", ["always", "never"], indirect=True)
def test_pct_train_step_matches_jax_f64(jax_side):
    """Loss terms of two steps, every gradient leaf of the first, the
    parameters and running statistics after two Adam steps, the eval step
    after them, and the weight bridge's round trip of the trained state."""
    side = jax_side
    host = _batch(3)
    jb, pb = jax_inputs(host), to_device(host, "cpu")

    want_grads = _flax_named(_jax_loss_grads(side, jb), side["batch_stats"],
                             with_stats=False)
    state = _jax_state(side)
    want_losses = []
    with nn.intercept_methods(_no_dropout):
        for _ in range(2):
            state, metrics = side["train_step"](state, jb)
            want_losses.append({k: float(expect_dtype(v)) for k, v in metrics.items()})
        want_eval = side["eval_step"](state.params, state.batch_stats, jb)
    expect_dtype([want_eval[k] for k in ("loss", "sim", "rr_sum")], what="JAX eval")
    trained = jax.tree.map(np.asarray, (state.params, state.batch_stats))
    want_params = _flax_named(*trained)

    port = _port_state(side)
    step = make_train_step(MODULES)
    got_losses = [step(port, pb)]
    got_grads = _named(port.model, port.objective, grads=True)
    got_losses.append(step(port, pb))
    got_eval = make_eval_step(port.model, port.objective, MODULES, with_sim=True)(pb)

    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k].item(), w[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {i}: {k}")
    assert want_losses[1]["loss"] < want_losses[0]["loss"]
    _assert_named_close(got_grads, want_grads, "gradients")
    assert all(float(got_grads[k].abs().max()) > 0 for k in got_grads
               if k.startswith("object_encoder.") and ".after_norm." not in k)
    got_params = _named(port.model, port.objective)
    _assert_named_close({k: v for k, v in got_params.items() if "running_" not in k},
                        {k: v for k, v in want_params.items() if "running_" not in k},
                        "parameters after 2 steps", PARAM_TOL)
    _assert_named_close({k: v for k, v in got_params.items() if "running_" in k},
                        {k: v for k, v in want_params.items() if "running_" in k},
                        "running statistics after 2 steps")
    start = _flax_named(side["params"], side["batch_stats"])
    assert all(not np.array_equal(want_params[k].numpy(), start[k].numpy())
               for k in want_params if "running_" in k)
    assert (port.step, port.updates, port.skipped) == (2, 2, 0)

    np.testing.assert_allclose(got_eval["loss"].item(), float(want_eval["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_eval["sim"].numpy(), np.asarray(want_eval["sim"]),
                               rtol=TOL[0], atol=TOL[1])
    assert int(got_eval["rr_count"]) == int(want_eval["rr_count"])
    np.testing.assert_allclose(float(got_eval["rr_sum"]), float(want_eval["rr_sum"]),
                               rtol=1e-9)

    # weight bridge: the trained state -> the port -> the JAX tree, leaf for leaf
    ported = MultiModalEncoder(MODULES, dtype=torch.float64, **WIDTHS).double()
    ported.load_state_dict(state_dict_from_flax(trained[0]["model"], trained[1], MODULES))
    back_p, back_s = torch_state_dict_to_params(ported.state_dict(), MODULES)
    for want, got in ((trained[0]["model"], back_p), (trained[1], back_s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf,
                                          err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("jax_side", ["never"], indirect=True)
def test_nonfinite_pct_step_skips_update_but_moves_running_stats(jax_side):
    """A NaN in one anchor's attribute features: the loss and the gradients
    are not finite, so both sides keep parameters and Adam's state; the
    point-encoder path stays finite, and its BatchNorm running statistics
    move on both sides (JAX assigns the new batch_stats whether or not
    apply_if_finite skips the update), to the same values."""
    side = jax_side
    good, bad = _batch(3), _batch(3, nan_attr=True)
    state = _jax_state(side)
    with nn.intercept_methods(_no_dropout):
        state, _ = side["train_step"](state, jax_inputs(good))
        before = jax.tree.map(np.asarray, (state.params, state.opt_state.inner_state,
                                           state.batch_stats))
        state, metrics = side["train_step"](state, jax_inputs(bad))
    assert not np.isfinite(float(metrics["loss"]))
    after = jax.tree.map(np.asarray, (state.params, state.opt_state.inner_state))
    jax.tree.map(np.testing.assert_array_equal, after, before[:2])
    assert int(state.opt_state.notfinite_count) == 1
    want_stats = {k: v for k, v in _flax_named(
        jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats)
    ).items() if "running_" in k}
    stats_before = _flax_named(jax.tree.map(np.asarray, state.params), before[2])
    for k, v in want_stats.items():
        assert np.isfinite(v.numpy()).all() and not np.array_equal(
            v.numpy(), stats_before[k].numpy()), k

    port = _port_state(side)
    step = make_train_step(MODULES)
    step(port, to_device(good, "cpu"))
    params_before = {k: v for k, v in _named(port.model, port.objective).items()
                     if "running_" not in k}
    opt_before = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in port.optimizer.state.items()}
    out = step(port, to_device(bad, "cpu"))
    assert not torch.isfinite(out["loss"])
    got = _named(port.model, port.objective)
    for k, v in params_before.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    for k, v in port.optimizer.state.items():
        for n, t in v.items():
            torch.testing.assert_close(t, opt_before[k][n], rtol=0, atol=0)
    _assert_named_close({k: got[k] for k in want_stats}, want_stats,
                        "running stats after the skipped step")
    assert (port.step, port.updates, port.skipped) == (2, 1, 1)


# --------------------------------- dropout ----------------------------------

def test_head_dropout_in_train_mode():
    """NaivePCT's head draws Dropout(0.5) in train mode from the caller's
    generator: one seed gives one output, another seed another, and rate 0
    gives the undropped output. Eval mode applies none."""
    torch.manual_seed(0)
    model = MultiModalEncoder(MODULES, **WIDTHS)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in model.parameters():
            prm.normal_(0.0, 0.2, generator=g)
    batch = to_device(_batch(4), "cpu")
    enc = model.object_encoder
    assert enc.dropout == 0.5
    with torch.no_grad():
        model.train(True)
        a = model(batch, generator=torch.Generator().manual_seed(3))["pct"]
        b = model(batch, generator=torch.Generator().manual_seed(3))["pct"]
        c = model(batch, generator=torch.Generator().manual_seed(4))["pct"]
        enc.dropout = 0.0
        plain = model(batch, generator=torch.Generator().manual_seed(3))["pct"]
        model.train(False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
