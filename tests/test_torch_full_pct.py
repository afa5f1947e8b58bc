"""FullPCT through the port against the JAX package, on the CPU: the KNN
grouping (``ops/knn.py``, ties included), ``SGModule``, the block ops at
FullPCT's width (C=256, da=64: ``pct_block_eval`` and the training block
``pct_block_residual`` with its backward, SA and OA) and ``FullPCT`` in
eval and train mode, with the weight bridge ``full_pct_state_dict_from_flax``
and its inverse.

Sizes: O=4 objects, the last one padded (all-zero points), N=64 points an
object, samples (32, 16); the widths are FullPCT's own (64, 128, 256, the
tail 1280 -> 1024, the head 512 -> 256). Every JAX block op takes its Pallas
kernel at these shapes, in interpret mode (``fused="always"``). Inputs and
weights come from numpy with fixed seeds; the JAX side runs under x64 for
the float64 comparisons (``expect_dtype``), its functions compiled once for
the float64 tests (a class-scoped fixture) and once for the float32 ones.
The head's dropout is intercepted on the JAX side and set to 0 in the port,
as tests/test_torch_pct_training.py does.

Tolerances are tests/test_torch_oa.py's: float64 rtol 1e-8 with an absolute
floor of 1e-9 of the largest value compared; float32 against the Pallas
kernels (the block ops, and FullPCT's eval output) normwise 1e-5. The block
ops' q/k weight is scaled as that file's C=256 cases are (the energies stay
O(1), so dq is not rounding noise).
"""

from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgaligner_tpu.models.pct import FullPCT as JaxFullPCT
from sgaligner_tpu.models.pct import SGModule as JaxSGModule
from sgaligner_tpu.ops import knn as jknn
from sgaligner_tpu.ops import pct_attention as jpa
from sgaligner_tpu_torch.core.checkpoint import (full_pct_flax_from_state_dict,
                                                 full_pct_state_dict_from_flax)
from sgaligner_tpu_torch.models.pct import FullPCT, SGModule
from sgaligner_tpu_torch.ops import knn
from sgaligner_tpu_torch.ops.pct_attention import BlockResidual, block_eval_plain
from tests.test_torch_oa import (_attn_case, _check_model, _close, _jax_model, _jax_run,
                                 _normwise, _port_run)
from tests.test_torch_ops import expect_dtype, to_jax

O, N, SAMPLES, C = 4, 64, (32, 16), 256
F32_NORMWISE = 1e-5
FLAGS = pytest.mark.parametrize("flags", [(True, False), (False, True)], ids=["SA", "OA"])
TRAIN = pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _mask():
    m = np.ones(O, bool)
    m[-1] = False
    return m


def _points(rng):
    """[O, N, 3]: the last (padded) object all zeros, and in object 0 the
    second half a copy of the first (exact distance ties)."""
    pts = rng.normal(size=(O, N, 3))
    pts[0, N // 2:] = pts[0, :N // 2]
    pts[-1] = 0.0
    return pts


def _sg_state_dict(params, stats):
    """A flax SGModule tree -> the port's SGModule state_dict."""
    sd = {}
    for i in (1, 2):
        sd[f"conv{i}.weight"] = torch.from_numpy(
            np.asarray(params[f"conv{i}"]["kernel"]).T[:, :, None].copy())
        for key, tree, leaf in (("weight", params, "scale"), ("bias", params, "bias"),
                                ("running_mean", stats, "mean"), ("running_var", stats, "var")):
            sd[f"bn{i}.{key}"] = torch.from_numpy(np.array(tree[f"bn{i}"][leaf]))
    return sd


def _block_args(rng, flags):
    """x, the five block weights, the BN scale and bias, mask [O, 1], count,
    and the cotangents of (x_next, ssum, ssumsq)."""
    p = SAMPLES[1]
    x, wqk, wv, bv = _attn_case(rng, C)
    x = x[:, :p]
    wt, bt = rng.normal(size=(C, C)) / np.sqrt(C), rng.normal(size=(C,)) * 0.1
    scale, bias = 1.0 + 0.2 * rng.normal(size=(C,)), 0.1 * rng.normal(size=(C,))
    m = _mask()[:, None].astype(np.float64)
    cts = (rng.normal(size=(O, p, C)), rng.normal(size=(1, C)) * 0.1,
           rng.normal(size=(1, C)) * 0.01)
    return (x, wqk, wv, bv, wt, bt, scale, bias, m), float(m.sum() * p), cts


def _jax_blocks(args, count, cts, flags, dtype):
    """JAX pct_block_eval (running-statistics fold from the BN scale and
    bias, as an eval fold) and pct_block_residual's outputs and vjp."""
    x, wqk, wv, bv, wt, bt, scale, bias, m = (jnp.asarray(a, dtype) for a in args)
    acc = dtype if dtype == jnp.float64 else jnp.float32
    ev = jpa.pct_block_eval(x, wqk, wv, bv, wt, bt, scale.astype(acc), bias.astype(acc),
                            *flags, True)
    outs, vjp = jax.vjp(lambda *a: jpa.pct_block_residual(
        *a, m, jnp.asarray(count, jnp.float32), *flags, 1e-5, True),
        x, wqk, wv, bv, wt, bt, scale.astype(acc), bias.astype(acc))
    grads = vjp((jnp.asarray(cts[0], dtype), jnp.asarray(cts[1], acc),
                 jnp.asarray(cts[2], acc)))
    return [ev, *outs], grads


def _port_blocks(args, count, cts, flags, dtype):
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    ts = [torch.from_numpy(np.asarray(a)).to(dtype) for a in args]
    x, wqk, wv, bv, wt, bt, scale, bias, m = ts
    ev = block_eval_plain(x, wqk, wv, bv, wt, bt, scale.to(acc), bias.to(acc), *flags)
    leaves = [t.requires_grad_(True) for t in (x, wqk, wv, bv, wt, bt)]
    bn = [scale.to(acc).requires_grad_(True), bias.to(acc).requires_grad_(True)]
    outs = BlockResidual.apply(*leaves, *bn, m, torch.tensor(count, dtype=torch.float32),
                               *flags, 1e-5)
    grads = torch.autograd.grad(outs, leaves + bn, (torch.from_numpy(cts[0]).to(dtype),
                                                   torch.from_numpy(cts[1]).to(acc),
                                                   torch.from_numpy(cts[2]).to(acc)))
    return [ev, *(t.detach() for t in outs)], grads


@pytest.fixture(scope="class")
def x64_class():
    """float64 JAX for the tests of one class (caches cleared on entry and
    on exit, as tests/test_torch_ops.py's ``x64``)."""
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


@pytest.mark.usefixtures("x64_class")
class TestFloat64:

    def test_knn_matches_jax(self):
        """knn_point's index sets (ties to the lower index) and
        sample_and_knn_group's centres and grouped features, on objects with
        repeated points and an all-zero one."""
        rng = np.random.default_rng(0)
        pts, feats = _points(rng), rng.normal(size=(O, N, 8))
        queries = pts[:, ::5]
        want = np.asarray(jknn.knn_point(16, *to_jax(pts, queries)))
        got = knn.knn_point(16, torch.from_numpy(pts), torch.from_numpy(queries))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        # the ties: a repeated point's copy comes right after it; the zero
        # object lists its points in order
        assert (want[0, :, :2] % (N // 2) == want[0, :, :1] % (N // 2)).all()
        np.testing.assert_array_equal(want[-1], np.broadcast_to(np.arange(16), want[-1].shape))
        for s, k in ((32, 16), (16, 32)):
            want = jknn.sample_and_knn_group(s, k, *to_jax(pts, feats))
            got = knn.sample_and_knn_group(s, k, torch.from_numpy(pts), torch.from_numpy(feats))
            _close(got, want, f"sample_and_knn_group s={s} k={k}")

    @TRAIN
    def test_sgmodule_matches_jax(self, train):
        """SGModule(s=32, 128 -> 128) on the neighbour embedding's 64-wide
        features: the centres and features; after a train call the running
        statistics (the BN counts valid objects x s x 32 rows) and the
        parameters' and the features' gradients."""
        rng = np.random.default_rng(1)
        pts, feats = _points(rng), rng.normal(size=(O, N, 64))
        m = _mask()
        model = JaxSGModule(SAMPLES[0], 128, dtype=jnp.float64)
        inputs = (*to_jax(feats, pts), jnp.asarray(m))
        params, stats = _jax_model(model, inputs, seed=2)
        net = SGModule(SAMPLES[0], 128, 128).double()
        cts = [rng.normal(size=(O, SAMPLES[0], 3)), rng.normal(size=(O, SAMPLES[0], 128))]
        # coords ask for a gradient only so that the centres, gathered from
        # them, join the graph the cotangents are pulled through
        _check_model(net, model, inputs,
                     (torch.from_numpy(feats), torch.from_numpy(pts).requires_grad_(train),
                      torch.from_numpy(m)),
                     params, stats, train, cts, wrt_input=True, bridge=_sg_state_dict)

    @FLAGS
    def test_block_ops_match_jax(self, flags):
        """At C=256: pct_block_eval (row 5), and pct_block_residual's outputs
        (row 6's forward, the fold and the epilogue) and its gradients for x,
        the five weights and the BN scale and bias (rows 8 and 9)."""
        rng = np.random.default_rng(3)
        args, count, cts = _block_args(rng, flags)
        assert jpa._block_pick_tile(O, SAMPLES[1], C, C // 4, 8, bwd=False) is not None
        expect_dtype(to_jax(*args, *cts))
        want, want_g = _jax_blocks(args, count, cts, flags, jnp.float64)
        got, got_g = _port_blocks(args, count, cts, flags, torch.float64)
        _close(got, want, "pct_block_eval and pct_block_residual forward")
        _close(got_g, want_g, "pct_block_residual gradients")

    @TRAIN
    def test_full_pct_matches_jax(self, train):
        """FullPCT's output; after one train call every running statistic
        and every parameter's gradient, through the weight bridge."""
        rng = np.random.default_rng(4)
        pts, m = _points(rng), _mask()
        model = JaxFullPCT(samples=SAMPLES, dtype=jnp.float64, fused="always")
        inputs = (*to_jax(pts), jnp.asarray(m))
        with nn.intercept_methods(_no_dropout):
            params, stats = _jax_model(model, inputs, seed=5)
            net = FullPCT(samples=SAMPLES, dtype=torch.float64).double()
            net.dropout = 0.0
            _check_model(net, model, inputs, (torch.from_numpy(pts), torch.from_numpy(m)),
                         params, stats, train, [rng.normal(size=(O, 256))],
                         bridge=full_pct_state_dict_from_flax)


@FLAGS
def test_block_ops_match_jax_kernels_f32(flags):
    """x64 off, C=256: the JAX side is the Pallas kernels _block_eval_kernel,
    _block_fwd_kernel, _epi_sums_kernel and _block_res_bwd_kernel
    (interpret mode)."""
    assert not jax.config.jax_enable_x64
    rng = np.random.default_rng(3)
    args, count, cts = _block_args(rng, flags)
    assert jpa._block_pick_tile(O, SAMPLES[1], C, C // 4, 4, bwd=True) is not None
    want, want_g = _jax_blocks(args, count, cts, flags, jnp.float32)
    got, got_g = _port_blocks(args, count, cts, flags, torch.float32)
    expect_dtype([want, want_g], jnp.float32, what="JAX f32")
    for i, (g, w) in enumerate(zip((*got, *got_g), (*want, *want_g))):
        assert g.dtype == torch.float32, i
        err = _normwise(g, w)
        assert err <= F32_NORMWISE, (i, err)


def test_full_pct_bridge_round_trip():
    """flax FullPCT tree -> the port's state_dict (every key of the module
    filled) -> the flax tree again, leaf for leaf."""
    model = JaxFullPCT(samples=SAMPLES, fused="always")
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.key(0),
                            jnp.zeros((2, N, 3)), jnp.ones((2,), bool))
    rng = np.random.default_rng(6)
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    net = FullPCT(samples=SAMPLES)
    net.load_state_dict(full_pct_state_dict_from_flax(tree["params"], tree["batch_stats"]))
    params, stats = full_pct_flax_from_state_dict(net.state_dict())
    for want, got in ((tree["params"], params), (tree["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf,
                                          err_msg=jax.tree_util.keystr(path))


def test_full_pct_eval_matches_jax_kernels_f32():
    """x64 off: FullPCT's eval output against the JAX model on the Pallas
    kernels (interpret mode), normwise. (Train mode is held at float64
    above: its BatchNorms fold from one-pass batch moments, where float32
    rounding alone moves the output by about 1e-4 on either side.)"""
    assert not jax.config.jax_enable_x64
    rng = np.random.default_rng(4)
    pts, m = _points(rng).astype(np.float32), _mask()
    model = JaxFullPCT(samples=SAMPLES, fused="always")
    inputs = (jnp.asarray(pts), jnp.asarray(m))
    params, stats = _jax_model(model, inputs, seed=5)
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
                     for t in (params, stats))
    want = _jax_run(model, params, stats, inputs, False, None)[0]
    net = FullPCT(samples=SAMPLES)
    net.load_state_dict(full_pct_state_dict_from_flax(params, stats))
    got = _port_run(net, (torch.from_numpy(pts), torch.from_numpy(m)), False, None, False)[0]
    expect_dtype(want, jnp.float32, what="JAX f32")
    assert got.dtype == torch.float32
    assert _normwise(got, want) <= F32_NORMWISE
