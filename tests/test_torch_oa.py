"""The offset-attention (OA) family of the port against the JAX package, on
the CPU: the ops ``pct_attention_fused`` (at all four (scale, double_norm)
pairs at f64) and ``pct_block_fused`` with their gradients (SA and OA),
``OABlock`` and ``SPCT`` in eval and train mode, and
the weight bridge ``spct_state_dict_from_flax``.

Widths are the models' (C=128, da=32, the tail 512 -> 1024; the block op and
``OABlock`` also at FullPCT's C=256, da=64); O=4 objects, the last one
padded, of P=16 points. Every JAX tile picker takes its Pallas
kernel at these shapes (each test asserts it), run in interpret mode; the
JAX ``pct_block_residual`` backward runs its pure-JAX fallback at f64 (its
kernels take f32 / bf16). Inputs and weights come from numpy with fixed
seeds.

Tolerances:

* float64: rtol 1e-8, with an absolute floor of 1e-9 of the largest value of
  what is compared (one leaf, or for the model's gradients all leaves
  together). Both sides compute the same f64 arithmetic in another order. The
  floor covers sums that cancel to near zero: the trans biases sit right
  before a batch-statistics BatchNorm, whose mean removes them, so their
  gradients are rounding noise (~1e-15) on both sides. A wrong axis, mask,
  normalisation or rounding step gives errors above 1e-4.
* float32, x64 off, against the Pallas kernels: normwise (max |error| / max
  |value| per output) 1e-5: f32 sums in another order (measured 6e-8 to
  3.3e-6, the largest on the OA attention's dWqk).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.models.pct import SPCT as JaxSPCT
from sgaligner_tpu.models.pct import OABlock as JaxOABlock
from sgaligner_tpu.ops import pct_attention as jpa
from sgaligner_tpu_torch.core.checkpoint import spct_state_dict_from_flax
from sgaligner_tpu_torch.models.pct import SPCT, OABlock
from sgaligner_tpu_torch.ops.pct_attention import pct_attention_fused, pct_block_fused
from tests.test_torch_ops import expect_dtype, to_jax, x64  # noqa: F401  (fixture)

O, P, C, DA = 4, 16, 128, 32
RTOL, FLOOR = 1e-8, 1e-9
F32_NORMWISE = 1e-5
FLAGS = pytest.mark.parametrize("flags", [(True, False), (False, True)], ids=["SA", "OA"])
WIDTH = pytest.mark.parametrize("c", [C, 2 * C], ids=["C128", "C256"])
# the attention op takes scale and double_norm independently: SA, OA and the
# mixed pairs (SA's scale with OA's normalisation, and neither)
PAIRS = pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True),
                                          (False, False)], ids=["SA", "OA", "both", "neither"])


def _close(got, want, what, floor=None):
    """Each port tensor against its JAX array at rtol RTOL, absolute floor
    FLOOR x the largest |value| (of that array, or ``floor`` if given)."""
    expect_dtype(list(want), what=what)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.float64, f"{what}: output {i} is {g.dtype}"
        scale = floor if floor is not None else float(np.abs(w).max())
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=FLOOR * max(scale, 1e-30),
                                   err_msg=f"{what}: output {i}")


def _normwise(got, want):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _mask(o=O):
    m = np.ones((o, 1))
    m[-1] = 0.0
    return m


def _attn_case(rng, c=C):
    """x, wqk, wv, bv. At C=256 wqk is scaled by (C·sqrt(da))^-1/2 (at C=128
    by C^-1/2, as before): at C^-1/2 the energies' diagonal |q|² (about da
    = 64) leaves each column softmax one-hot to f32 precision, and dq would be
    pure rounding noise on both sides."""
    wqk_scale = np.sqrt(c) if c == C else np.sqrt(c * np.sqrt(c // 4))
    return (rng.normal(size=(O, P, c)), rng.normal(size=(c, c // 4)) / wqk_scale,
            rng.normal(size=(c, c)) / np.sqrt(c), rng.normal(size=(c,)) * 0.1)


def _block_case(rng, c=C):
    x, wqk, wv, bv = _attn_case(rng, c)
    return (x, wqk, wv, bv, rng.normal(size=(c, c)) / np.sqrt(c),
            rng.normal(size=(c,)) * 0.1)


# ------------------------------------ ops -----------------------------------

def _jax_attn(args, ct, flags, dtype):
    arrs = [jnp.asarray(a, dtype) for a in args]
    out, vjp = jax.vjp(lambda *a: jpa.pct_attention_fused(*a, *flags, True), *arrs)
    return out, vjp(jnp.asarray(ct, dtype))


def _port_attn(args, ct, flags, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in args]
    out = pct_attention_fused(*ts, *flags)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(ct).to(dtype))


@PAIRS
def test_attention_fused_matches_jax_f64(x64, flags):
    rng = np.random.default_rng(0)
    args = _attn_case(rng)
    ct = rng.normal(size=(O, P, C))
    for bwd in (False, True):
        assert jpa._pick_tile(O, P, C, DA, 8, bwd=bwd) is not None   # Pallas kernels
    expect_dtype(to_jax(*args, ct))
    want, want_g = _jax_attn(args, ct, flags, jnp.float64)
    got, got_g = _port_attn(args, ct, flags, torch.float64)
    _close([got], [want], "pct_attention_fused forward")
    _close(got_g, want_g, "pct_attention_fused grads (x, wqk, wv, bv)")


def _jax_block(args, m, cts, flags, dtype):
    arrs = [jnp.asarray(a, dtype) for a in args]
    mj = jnp.asarray(m, dtype)
    outs, vjp = jax.vjp(lambda *a: jpa.pct_block_fused(*a, mj, *flags, True), *arrs)
    acc = dtype if dtype == jnp.float64 else jnp.float32
    return outs, vjp((jnp.asarray(cts[0], dtype), jnp.asarray(cts[1], acc),
                      jnp.asarray(cts[2], acc)))


def _port_block(args, m, cts, flags, dtype):
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in args]
    outs = pct_block_fused(*ts, torch.from_numpy(m).to(dtype), *flags)
    grads = torch.autograd.grad(outs, ts, (torch.from_numpy(cts[0]).to(dtype),
                                           torch.from_numpy(cts[1]).to(acc),
                                           torch.from_numpy(cts[2]).to(acc)))
    return outs, grads


def _block_cts(rng, c=C):
    return (rng.normal(size=(O, P, c)), rng.normal(size=(1, c)) * 0.1,
            rng.normal(size=(1, c)) * 0.01)


@WIDTH
@FLAGS
def test_block_fused_matches_jax_f64(x64, flags, c):
    rng = np.random.default_rng(1)
    args, m, cts = _block_case(rng, c), _mask(), _block_cts(rng, c)
    for bwd in (False, True):
        assert jpa._block_pick_tile(O, P, c, c // 4, 8, bwd=bwd) is not None
    expect_dtype(to_jax(*args, m, *cts))
    want, want_g = _jax_block(args, m, cts, flags, jnp.float64)
    got, got_g = _port_block(args, m, cts, flags, torch.float64)
    _close(got, want, "pct_block_fused forward (t_out, ssum, ssumsq)")
    _close(got_g, want_g, "pct_block_fused grads (x, wqk, wv, bv, wt, bt)")


@pytest.mark.parametrize("op,c", [("attention", C), ("block", C), ("block", 2 * C)],
                         ids=["attention", "block", "block-C256"])
@FLAGS
def test_ops_match_jax_kernels_f32(op, flags, c):
    """x64 off: the JAX side is the Pallas kernels _fwd_kernel / _bwd_kernel
    and _block_fwd_kernel / _block_bwd_kernel (interpret mode)."""
    assert not jax.config.jax_enable_x64
    rng = np.random.default_rng(2)
    if op == "attention":
        args, ct = _attn_case(rng), rng.normal(size=(O, P, C))
        assert jpa._pick_tile(O, P, C, DA, 4, bwd=True) is not None
        want, want_g = _jax_attn(args, ct, flags, jnp.float32)
        got, got_g = _port_attn(args, ct, flags, torch.float32)
        want, got = [want], [got]
    else:
        args, m, cts = _block_case(rng, c), _mask(), _block_cts(rng, c)
        assert jpa._block_pick_tile(O, P, c, c // 4, 4, bwd=True) is not None
        want, want_g = _jax_block(args, m, cts, flags, jnp.float32)
        got, got_g = _port_block(args, m, cts, flags, torch.float32)
    expect_dtype([want, want_g], jnp.float32, what="JAX f32")
    for i, (g, w) in enumerate(zip((*got, *got_g), (*want, *want_g))):
        assert g.dtype == torch.float32, i
        err = _normwise(g, w)
        assert err <= F32_NORMWISE, (op, i, err)


# ---------------------------------- models ----------------------------------

def _seeded_tree(shapes, rng):
    """Seeded float64 parameters and running statistics for a flax tree of
    ShapeDtypeStructs: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1²), BN
    scale ~ 1 + N(0, 0.2²), means ~ N(0, 0.1²), variances in [0.5, 1.5)."""

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        elif "scale" in name:
            a = 1.0 + 0.2 * rng.normal(size=s.shape)
        elif "var" in name:
            a = 0.5 + rng.random(s.shape)
        else:                                   # biases, BN biases, means
            a = 0.1 * rng.normal(size=s.shape)
        return jnp.asarray(a, jnp.float64)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_model(model, inputs, seed):
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.key(0), *inputs)
    v = _seeded_tree(shapes, np.random.default_rng(seed))
    return v["params"], v["batch_stats"]


def _jax_run(model, params, stats, inputs, train, cts):
    """(outputs, updated batch_stats, gradients of the parameters and of the
    first input for cts), jitted; eval: outputs only."""
    if not train:
        return jax.jit(lambda p, s, *a: model.apply(
            {"params": p, "batch_stats": s}, *a, False))(params, stats, *inputs), None, None

    @jax.jit
    def run(p, s, a, c):
        def f(p_, x_):
            return model.apply({"params": p_, "batch_stats": s}, x_, *a[1:], True,
                               mutable=["batch_stats"])
        outs, vjp, upd = jax.vjp(f, p, a[0], has_aux=True)
        ct = tuple(c) if isinstance(outs, tuple) else c[0]
        return outs, upd["batch_stats"], vjp(ct)

    return run(params, stats, inputs, cts)


def _port_run(net, inputs, train, cts, wrt_input):
    """Outputs; train: the parameters' gradients by name, and the first
    input's under "input" if ``wrt_input``."""
    net.train(train)
    if not train:
        with torch.no_grad():
            return net(*inputs), None
    inputs = (inputs[0].clone().requires_grad_(wrt_input), *inputs[1:])
    outs = net(*inputs)
    names, prms = zip(*net.named_parameters())
    if wrt_input:
        names, prms = (*names, "input"), (*prms, inputs[0])
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, prms, [torch.from_numpy(np.asarray(c)) for c in cts])
    return outs, dict(zip(names, grads))


def _check_model(net, model, inputs, port_inputs, params, stats, train, cts,
                 wrt_input=False, bridge=spct_state_dict_from_flax):
    """Outputs; after a train call the running statistics and every
    parameter gradient, all through the weight bridge ``bridge``, and with
    ``wrt_input`` the first input's gradient."""
    net.load_state_dict(bridge(params, stats))
    want, upd, want_g = _jax_run(model, params, stats, inputs, train, cts)
    got, got_g = _port_run(net, port_inputs, train, cts, wrt_input)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    _close(got, want, f"outputs (train={train})")
    if not train:
        return
    want_sd = bridge(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, upd))
    stats_keys = [k for k in want_sd if "running_" in k]
    assert len(stats_keys) == 2 * sum(1 for m in net.modules()
                                      if hasattr(m, "running_mean"))
    port_sd = net.state_dict()
    _close([port_sd[k] for k in stats_keys], [want_sd[k].numpy() for k in stats_keys],
           "running statistics after one train call")
    start = bridge(params, stats)
    assert all(not np.array_equal(want_sd[k].numpy(), start[k].numpy())
               for k in stats_keys)
    if wrt_input:
        _close([got_g.pop("input")], [want_g[1]], "input gradient")
    want_grads = {k: v for k, v in bridge(
        expect_dtype(jax.tree.map(np.asarray, want_g[0])), jax.tree.map(np.asarray, stats)
    ).items() if "running_" not in k}
    assert sorted(want_grads) == sorted(got_g)
    top = max(float(np.abs(v.numpy()).max()) for v in want_grads.values())
    _close([got_g[k] for k in want_grads], [v.numpy() for v in want_grads.values()],
           "parameter gradients", floor=top)


@WIDTH
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_oablock_matches_jax_f64(x64, train, c):
    """Output; after one train-mode call the running statistics, the
    parameters' and the input's gradients."""
    rng = np.random.default_rng(3)
    x, m = rng.normal(size=(O, P, c)), _mask()[:, 0] > 0
    model = JaxOABlock(c, dtype=jnp.float64, fused="always")
    inputs = (*to_jax(x), jnp.asarray(m))
    params, stats = _jax_model(model, inputs, seed=4)
    assert set(params) == {"qk", "v", "trans", "after_norm"}
    net = OABlock(c).double()
    kmask = torch.from_numpy(m).double()[:, None]
    count = torch.tensor(max(float(m.sum()) * P, 1.0), dtype=torch.float32)
    _check_model(net, model, inputs, (torch.from_numpy(x), kmask, count),
                 params, stats, train, [rng.normal(size=(O, P, c))], wrt_input=True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spct_matches_jax_f64(x64, train):
    """All three outputs; after one train-mode call every batch_stats leaf
    and every parameter gradient for seeded cotangents on the outputs."""
    rng = np.random.default_rng(5)
    pts, m = rng.normal(size=(O, P, 3)), _mask()[:, 0] > 0
    model = JaxSPCT(dtype=jnp.float64, fused="always")
    inputs = (*to_jax(pts), jnp.asarray(m))
    params, stats = _jax_model(model, inputs, seed=6)
    net = SPCT(torch.float64).double()
    cts = [rng.normal(size=(O, P, 1024)) * 1e-2, rng.normal(size=(O, 1024)),
           rng.normal(size=(O, 1024))]
    _check_model(net, model, inputs, (torch.from_numpy(pts), torch.from_numpy(m)),
                 params, stats, train, cts)


def test_spct_bridge_round_trip():
    """flax SPCT tree -> the port's state_dict -> the flax tree again, leaf
    for leaf, every key of the port module filled."""
    model = JaxSPCT(fused="always")
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.key(0),
                            jnp.zeros((2, 8, 3)), jnp.ones((2,), bool))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = spct_state_dict_from_flax(tree["params"], tree["batch_stats"])
    net = SPCT()
    net.load_state_dict(sd)                                   # strict: every key
    back = net.state_dict()

    def kernel(k):
        return back[k].numpy()[:, :, 0].T

    def bn(prefix):
        return ({"scale": back[f"{prefix}.weight"].numpy(),
                 "bias": back[f"{prefix}.bias"].numpy()},
                {"mean": back[f"{prefix}.running_mean"].numpy(),
                 "var": back[f"{prefix}.running_var"].numpy()})

    params, stats = {}, {}
    for i in (0, 1):
        params[f"emb{i}"] = {"kernel": kernel(f"embedding.conv{i + 1}.weight")}
        params[f"emb{i}_bn"], stats[f"emb{i}_bn"] = bn(f"embedding.bn{i + 1}")
    for s in (1, 2, 3, 4):
        q = f"sa{s}"
        an_p, an_s = bn(f"{q}.after_norm")
        params[q] = {"qk": {"kernel": kernel(f"{q}.q_conv.weight")},
                     "v": {"kernel": kernel(f"{q}.v_conv.weight"),
                           "bias": back[f"{q}.v_conv.bias"].numpy()},
                     "trans": {"kernel": kernel(f"{q}.trans_conv.weight"),
                               "bias": back[f"{q}.trans_conv.bias"].numpy()},
                     "after_norm": an_p}
        stats[q] = {"after_norm": an_s}
    params["linear"] = {"kernel": kernel("linear.0.weight")}
    params["linear_bn"], stats["linear_bn"] = bn("linear.1")
    for want, got in ((tree["params"], params), (tree["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf,
                                          err_msg=jax.tree_util.keystr(path))
