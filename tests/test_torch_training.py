"""The port's point-config training slice against the JAX package, at
float64 on the CPU.

The JAX model is ``MultiModalEncoder(('point','gat','rel','attr'),
dtype=float64)`` with the JAX ``build_optimizer`` (Adam, L2 decay,
``apply_if_finite``) and ``make_train_step``. Both sides start from the same
float64 weights, carried across by ``state_dict_from_flax``. Widths are cut
(pt_out_dim 32, emb_dim 16, GAT 3 -> 16 -> 16 with 2 heads, B=2 pairs of
8 + 8 slots, P=32). The train step is held against two JAX point encoders,
the other steps against the second alone (each JAX path compiles its own
steps, which is most of this file's time):

* ``pointnet_fused='always'``: the Pallas forward in interpret mode (its
  backward, at itemsize 8, is ``jax.grad`` of the unfused composition). That
  kernel accumulates in f32 and writes an f32 output whatever the input
  dtype, so the point embeddings carry f32 rounding (~1e-7): losses rtol
  1e-8, gradients atol 1e-6 (they reach ~4 here; measured 1.8e-7), the
  similarity matrices and the parameters after two Adam steps atol 1e-7
  (measured 1e-8).
* ``pointnet_fused='never'``: JAX's plain f64 composition. Both sides run
  the same f64 arithmetic in another summation order: losses rtol 1e-10,
  gradients, similarities and parameters rtol 1e-9 / atol 1e-12 (Adam
  divides by sqrt(v) + 1e-8, which can scale a tiny gradient's error up by
  a few orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.core.config import make_cfg as jax_make_cfg
from sgaligner_tpu.engine.factory import build_optimizer as jax_build_optimizer
from sgaligner_tpu.engine.train_step import TrainState as JaxTrainState
from sgaligner_tpu.engine.train_step import make_eval_step as jax_eval_step
from sgaligner_tpu.engine.train_step import make_serving_step as jax_serving_step
from sgaligner_tpu.engine.train_step import make_train_step as jax_train_step
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu.ops import losses as JL
from sgaligner_tpu.ops.objective import overall_loss as jax_overall_loss
from sgaligner_tpu_torch.core.checkpoint import (loss_state_dict_from_flax,
                                                 state_dict_from_flax)
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import (create_train_state,
                                                   make_eval_step,
                                                   make_serving_step,
                                                   make_train_step)
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.models.structure import dropout
from sgaligner_tpu_torch.ops import losses as L
from sgaligner_tpu_torch.ops.objective import OverallLoss, overall_loss
from tests.test_torch_model import jax_inputs
from tests.test_torch_ops import expect_dtype, to_jax, x64  # noqa: F401  (fixture)

MODULES = ("point", "gat", "rel", "attr")
WIDTHS = dict(pt_out_dim=32, emb_dim=16, hidden_units=(3, 16, 16), heads=(2, 2))
SPEC = BatchSpec(batch_size=2, max_objects=8, points_per_object=32)
BUCKET = 8
# per JAX point encoder: (loss rtol, gradient (rtol, atol), similarity and
# parameter (rtol, atol))
TOLS = {"always": (1e-8, (0.0, 1e-6), (0.0, 1e-7)),
        "never": (1e-10, (1e-9, 1e-12), (1e-9, 1e-12))}
LOSS_RTOL = 1e-10
LOSS_KEYS = ("loss", "icl_loss_unimodal", "icl_loss_multimodal", "ial_loss")


def _batch(seed, nan_anchor=False):
    host = make_synthetic_batch(SPEC, seed=seed, bow_noise=1.0, resample=True)
    if nan_anchor:
        host["obj_points"][0, host["e1i"][0, 0], 0, 0] = np.nan
    return pool_compact(host, BUCKET)


@pytest.fixture(scope="module")
def jax_side(request):
    """x64 while it lives; the JAX model, weights, optimizer and jitted
    steps built once per point-encoder path."""
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxEncoder(modules=MODULES, pointnet_fused=request.param,
                           dtype=jnp.float64, **WIDTHS)
        host = _batch(3)
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

        params = {
            "model": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
            "loss": {"ial_log_vars": jnp.asarray([0.1, -0.2, 0.05, 0.0]),
                     "icl_log_vars": jnp.asarray([-0.1, 0.2, 0.0, 0.15])},
        }
        cfg = jax_make_cfg(modules=list(MODULES))
        tx = jax_build_optimizer(cfg)
        yield {"fused": request.param, "model": model, "params": params, "tx": tx,
               "train_step": jax_train_step(model, tx, MODULES),
               "eval_step": jax_eval_step(model, MODULES, with_sim=True),
               "serving_step": jax_serving_step(model, MODULES)}
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


def _jax_state(side):
    # the jitted step donates its state: start from a copy of the weights
    params = jax.tree.map(jnp.copy, side["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=side["tx"].init(params), batch_stats={},
                         rng=jax.random.key(1))


def _port_state(side, params=None):
    params = side["params"] if params is None else params
    model = MultiModalEncoder(MODULES, dtype=torch.float64, **WIDTHS).double()
    model.load_state_dict(state_dict_from_flax(params["model"], {}, MODULES))
    objective = OverallLoss(MODULES).double()
    objective.load_state_dict(loss_state_dict_from_flax(params["loss"]))
    return create_train_state(model, make_cfg(modules=list(MODULES)), objective)


def _named_params(state):
    out = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    out.update({f"loss.{k}": v.detach().clone()
                for k, v in state.objective.state_dict().items()})
    return out


def _flax_named(tree):
    expect_dtype(tree, what="JAX parameters / gradients")
    out = dict(state_dict_from_flax(tree["model"], {}, MODULES))
    out.update({f"loss.{k}": v
                for k, v in loss_state_dict_from_flax(tree["loss"]).items()})
    return out


def _assert_named_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=f"{what}: {k}")


# ---------------------------------- losses ----------------------------------

def test_losses_match_jax_f64(x64):
    rng = np.random.default_rng(0)
    o, d, a, j1, j2 = 20, 8, 6, 5, 4
    emb, joint = rng.normal(size=(o, d)), rng.normal(size=(o, 3 * d))
    idx = [rng.integers(0, o, size=n) for n in (a, a, j1, j2)]
    masks = [np.arange(n) < k for n, k in ((a, 4), (j1, 3), (j2, 4))]
    np_args = (*idx, *masks)

    def jx(*arrs):
        return to_jax(*arrs)

    def tx(*arrs):
        return [torch.from_numpy(np.asarray(v)) for v in arrs]

    pairs = [
        (L.icl_loss(*tx(emb, *np_args)), JL.icl_loss(*jx(emb, *np_args))),
        (L.ial_loss(*tx(emb, joint, *np_args)),
         JL.ial_loss(*jx(emb, joint, *np_args))),
    ]
    losses, log_vars = rng.random(4), rng.normal(size=4) * 0.3
    pairs.append((L.kendall_combine(*tx(losses, log_vars)),
                  JL.kendall_combine(*jx(losses, log_vars))))
    for got, want in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)

    # overall_loss on a padded pair batch with random embeddings
    batch = make_synthetic_batch(SPEC, seed=2)
    n_obj = batch["obj_mask"].size
    embs = {m: rng.normal(size=(n_obj, d)) for m in MODULES}
    embs["joint"] = rng.normal(size=(n_obj, 4 * d))
    lp = {"ial_log_vars": rng.normal(size=4) * 0.2,
          "icl_log_vars": rng.normal(size=4) * 0.2}
    got = overall_loss({k: torch.from_numpy(v) for k, v in embs.items()},
                       to_device(batch, "cpu"),
                       {k: torch.from_numpy(v) for k, v in lp.items()}, MODULES)
    want = expect_dtype(jax_overall_loss(
        {k: to_jax(v)[0] for k, v in embs.items()}, jax_inputs(batch),
        {k: to_jax(v)[0] for k, v in lp.items()}, MODULES))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


# ------------------------------- train steps --------------------------------

@pytest.mark.parametrize("jax_side", ["always", "never"], indirect=True)
def test_train_step_matches_jax_f64(jax_side):
    host = _batch(3)
    jb = jax_inputs(host)
    pb = to_device(host, "cpu")
    side = jax_side

    # JAX: gradients at the starting weights, then two steps
    def loss_fn(params):
        embs = side["model"].apply({"params": params["model"]}, jb, train=True,
                                   rngs={"dropout": jax.random.key(2)})
        return jax_overall_loss(embs, jb, params["loss"], MODULES)["loss"]

    want_grads = _flax_named(jax.jit(jax.grad(loss_fn))(side["params"]))
    state = _jax_state(side)
    want_losses = []
    for _ in range(2):
        state, metrics = side["train_step"](state, jb)
        want_losses.append({k: float(expect_dtype(v)) for k, v in metrics.items()})
    want_params = _flax_named(jax.tree.map(np.asarray, state.params))

    port = _port_state(side)
    step = make_train_step(MODULES)
    got_losses = [step(port, pb)]
    got_grads = {k: p.grad.clone() for k, p in port.model.named_parameters()}
    got_grads.update({f"loss.{k}": p.grad.clone()
                      for k, p in port.objective.named_parameters()})
    got_losses.append(step(port, pb))

    loss_rtol, grad_tol, param_tol = TOLS[side["fused"]]
    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k].item(), w[k], rtol=loss_rtol,
                                       err_msg=f"step {i}: {k}")
    assert want_losses[1]["loss"] < want_losses[0]["loss"]
    _assert_named_close(got_grads, want_grads, grad_tol, "gradients")
    assert any(float(g.abs().max()) > 0 for k, g in got_grads.items()
               if k.startswith("object_encoder."))
    _assert_named_close(_named_params(port), want_params, param_tol,
                        "params after 2 steps")
    assert (port.step, port.updates, port.skipped) == (2, 2, 0)


@pytest.mark.parametrize("jax_side", ["never"], indirect=True)
def test_attr_bias_gradient_on_empty_rows_matches_jax(jax_side):
    """Objects with no attribute at all and meta_embedding_attr's bias at
    zero (its initial value): those objects' attribute embeddings are exact
    zeros, and l2_normalize's clamp (x·rsqrt(max(|x|², 1e-24))) scales
    their cotangent by 1e12 into the bias's gradient. The JAX train step's
    gradient does the same: the port matches it, huge value included (a
    reference quirk, README "Quirk parity")."""
    side = jax_side
    host = _batch(3)
    attr = host["bow_attr"].reshape(-1, host["bow_attr"].shape[-1])
    attr[np.flatnonzero(host["obj_mask"].reshape(-1))[:3]] = 0.0
    jb = jax_inputs(host)
    params = jax.tree.map(jnp.copy, side["params"])
    bias = params["model"]["meta_embedding_attr"]["bias"]
    params["model"]["meta_embedding_attr"]["bias"] = jnp.zeros_like(bias)

    def loss_fn(params):
        embs = side["model"].apply({"params": params["model"]}, jb, train=True,
                                   rngs={"dropout": jax.random.key(2)})
        return jax_overall_loss(embs, jb, params["loss"], MODULES)["loss"]

    want = _flax_named(jax.jit(jax.grad(loss_fn))(params))
    port = _port_state(side, params)
    make_train_step(MODULES)(port, to_device(host, "cpu"))
    got = {k: p.grad.clone() for k, p in port.model.named_parameters()}
    got.update({f"loss.{k}": p.grad.clone() for k, p in port.objective.named_parameters()})
    _assert_named_close(got, want, TOLS["never"][1], "gradients, empty attribute rows")
    key = "meta_embedding_attr.bias"
    assert float(want[key].abs().max()) > 1e9 and float(got[key].abs().max()) > 1e9


@pytest.mark.parametrize("jax_side", ["never"], indirect=True)
def test_nonfinite_step_is_skipped_on_both_sides(jax_side):
    side = jax_side
    good, bad = _batch(3), _batch(3, nan_anchor=True)
    assert np.isnan(bad["obj_points_pooled"]).any()

    state = _jax_state(side)
    state, _ = side["train_step"](state, jax_inputs(good))
    before = jax.tree.map(np.asarray, (state.params, state.opt_state.inner_state))
    state, metrics = side["train_step"](state, jax_inputs(bad))
    assert not np.isfinite(float(metrics["loss"]))
    after = jax.tree.map(np.asarray, (state.params, state.opt_state.inner_state))
    jax.tree.map(np.testing.assert_array_equal, after, before)
    assert int(state.opt_state.notfinite_count) == 1

    port = _port_state(side)
    step = make_train_step(MODULES)
    step(port, to_device(good, "cpu"))
    params_before = _named_params(port)
    opt_before = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in port.optimizer.state.items()}
    out = step(port, to_device(bad, "cpu"))
    assert not torch.isfinite(out["loss"])
    for k, v in _named_params(port).items():
        torch.testing.assert_close(v, params_before[k], rtol=0, atol=0)
    for k, v in port.optimizer.state.items():
        for n, t in v.items():
            torch.testing.assert_close(t, opt_before[k][n], rtol=0, atol=0)
    assert (port.step, port.updates, port.skipped) == (2, 1, 1)
    # the next finite step goes on from the kept state
    step(port, to_device(good, "cpu"))
    assert port.updates == 2


# ------------------------------ eval / serving ------------------------------

@pytest.mark.parametrize("jax_side", ["never"], indirect=True)
def test_eval_and_serving_steps_match_jax_f64(jax_side):
    side = jax_side
    host = _batch(5)
    jb = jax_inputs(host)
    want = side["eval_step"](side["params"], {}, jb)
    want_serve = side["serving_step"](side["params"], {}, jb)
    expect_dtype([want[k] for k in ("loss", "sim", "rr_sum", "alignment_score")]
                 + [want_serve[k] for k in ("rr_sum", "alignment_score")],
                 what="JAX eval / serving")

    port = _port_state(side)
    got = make_eval_step(port.model, port.objective, MODULES, with_sim=True)(
        to_device(host, "cpu"))
    got_serve = make_serving_step(port.model, MODULES)(to_device(host, "cpu"))

    loss_rtol, _, sim_tol = TOLS[side["fused"]]
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=loss_rtol)
    np.testing.assert_allclose(got["sim"].numpy(), np.asarray(want["sim"]),
                               rtol=sim_tol[0], atol=sim_tol[1])
    np.testing.assert_array_equal(got["pair_valid"].numpy(),
                                  np.asarray(want["pair_valid"]))
    for mode in ("2", "50", "100"):
        np.testing.assert_array_equal(got["sgar"][mode].numpy(),
                                      np.asarray(want["sgar"][mode]))
    for g, w in ((got, want), (got_serve, want_serve)):
        assert int(g["rr_count"]) == int(w["rr_count"])
        np.testing.assert_allclose(float(g["rr_sum"]), float(w["rr_sum"]),
                                   rtol=1e-9)
        np.testing.assert_allclose(g["alignment_score"].numpy(),
                                   np.asarray(w["alignment_score"]), rtol=1e-9)
        for k in (1, 2, 3, 4, 5):
            assert tuple(int(v) for v in g[f"hits@{k}"]) == \
                tuple(int(v) for v in w[f"hits@{k}"]), k
    assert float(want["rr_sum"]) < int(want["rr_count"])      # ranks not all 1


# --------------------------------- dropout ----------------------------------

def test_dropout_properties():
    """Dropout cannot match JAX's random bits; its properties are held
    instead: the share dropped is near p (4 sigma of a binomial over 10^5
    values), the kept values are scaled by 1/(1-p), one seed gives one
    mask, and p = 0 (the configured default) is the identity."""
    x = torch.ones(100_000, dtype=torch.float64)
    p = 0.3
    y = dropout(x, p, torch.Generator().manual_seed(0))
    dropped = float((y == 0).double().mean())
    assert abs(dropped - p) < 4 * np.sqrt(p * (1 - p) / x.numel())
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / (1.0 - p), rtol=1e-15)
    y2 = dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert not torch.equal(y, dropout(x, p, torch.Generator().manual_seed(1)))
    assert dropout(x, 0.0, None) is x

    # in the model: train mode draws from the state's generator, eval is exact
    model = MultiModalEncoder(MODULES, dropout=0.5, **WIDTHS)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in model.parameters():
            prm.normal_(0.0, 0.2, generator=g)
    batch = to_device(_batch(4), "cpu")
    with torch.no_grad():
        ref = model(batch)["gat"]
        model.train(True)
        a = model(batch, generator=torch.Generator().manual_seed(3))["gat"]
        b = model(batch, generator=torch.Generator().manual_seed(3))["gat"]
        model.train(False)
    assert torch.equal(a, b) and not torch.equal(a, ref)


# -------------------------------- schedules ---------------------------------

@pytest.mark.parametrize("scheduler", ["none", "exponential", "cosine",
                                       "warmup-cosine"])
def test_lr_schedules_match_jax(scheduler):
    from sgaligner_tpu.engine.factory import build_lr_schedule as jax_schedule
    from sgaligner_tpu_torch.engine.factory import build_lr_schedule

    optim = {"scheduler": scheduler, "steps_per_epoch": 3, "max_epoch": 4,
             "lr_decay_steps": 2, "warmup_steps": 5}
    want = jax_schedule(jax_make_cfg(modules=list(MODULES), optim=optim))
    got = build_lr_schedule(make_cfg(modules=list(MODULES), optim=optim))
    for count in range(16):
        w = want if isinstance(want, float) else float(want(count))
        np.testing.assert_allclose(got(count), w, rtol=1e-6, err_msg=str(count))
