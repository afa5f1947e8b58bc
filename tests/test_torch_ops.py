"""The port's four kernel ops (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode, at float64.

Narrow widths (P=32, C=32, da=8, K=64) and O=16 objects, so every JAX tile
picker takes its kernel (pct_tail's needs O % 8 == 0). Inputs come from
numpy with a fixed seed. Tolerance: rtol 1e-9 / atol 1e-8 — both sides
compute the same f64 arithmetic in a different summation order. The atol
covers the ~1.4e-9 absolute differences seen once, on a few small outputs of
the SA block, in a run with several workers (not reproduced since; listed in
ROADMAP.md under the port's faults). A wrong axis, scale or rounding step
gives errors of 1e-3 and more.

``to_jax`` and ``expect_dtype`` guard every f64 comparison of the port's
tests against a silent float32 on the JAX side: ``jnp.asarray`` of a
float64 array gives float32 when x64 is off, and an f64 tolerance would then
hold f32 results.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.ops.pct_attention import pct_block_eval as jax_block_eval
from sgaligner_tpu.ops.pct_embed import embed_first_fused, embed_second_fused
from sgaligner_tpu.ops.pct_tail import pct_tail_fused
from sgaligner_tpu_torch.ops.pct_attention import pct_block_eval
from sgaligner_tpu_torch.ops.pct_embed import embed_first, embed_second
from sgaligner_tpu_torch.ops.pct_tail import pct_tail

O, P, C, K = 16, 32, 32, 64
RTOL, ATOL = 1e-9, 1e-8


@pytest.fixture
def x64():
    """float64 JAX for one test, shared by the port's test files. JAX's
    trace and compile caches are cleared on entry and on exit, so nothing
    traced under one setting of ``jax_enable_x64`` is reused under the
    other."""
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


def expect_dtype(tree, dtype=jnp.float64, what: str = "JAX"):
    """Assert that every floating leaf of a JAX tree (arrays made for an f64
    comparison, or the outputs compared) has ``dtype``; returns the tree."""
    for leaf in jax.tree.leaves(tree):
        dt = np.asarray(leaf).dtype if not hasattr(leaf, "dtype") else leaf.dtype
        if jnp.issubdtype(dt, jnp.floating):
            assert dt == dtype, (f"{what}: {dt} where {jnp.dtype(dtype)} was "
                                 "expected (jax_enable_x64 off?)")
    return tree


def to_jax(*arrays):
    """numpy arrays -> JAX arrays, each floating one asserted float64."""
    return expect_dtype([jnp.asarray(a) for a in arrays], what="JAX input")


def _mask(rng):
    m = (rng.random((O, 1)) < 0.75).astype(np.float64)
    m[0] = 1.0
    return m


def _close(got, want, what):
    expect_dtype(list(want), what=what)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
            err_msg=f"{what}: output {i}")


def test_embed_first_matches_jax(x64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(O, 3, P))
    w = rng.normal(size=(3, C)) * 0.5
    m = _mask(rng)
    want = embed_first_fused(*to_jax(x, w, m), True)
    got = embed_first(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(m))
    _close(got, want, "embed_first")


def test_embed_second_matches_jax(x64):
    rng = np.random.default_rng(1)
    h0 = rng.normal(size=(O, P, C))
    wf = rng.normal(size=(1, C))
    bf = rng.normal(size=(1, C)) * 0.1
    w = rng.normal(size=(C, C)) / np.sqrt(C)
    m = _mask(rng)
    want = embed_second_fused(*to_jax(h0, wf, bf, w, m), True)
    got = embed_second(*(torch.from_numpy(a) for a in (h0, wf, bf, w, m)))
    _close(got, want, "embed_second")


@pytest.mark.parametrize("flags", [(True, False), (False, True)],
                         ids=["SA", "OA"])
def test_pct_block_eval_matches_jax(x64, flags):
    scale, double_norm = flags
    rng = np.random.default_rng(2)
    da = C // 4
    x = rng.normal(size=(O, P, C))
    wqk = rng.normal(size=(C, da)) / np.sqrt(C)
    wv = rng.normal(size=(C, C)) / np.sqrt(C)
    bv = rng.normal(size=(C,)) * 0.1
    wt = rng.normal(size=(C, C)) / np.sqrt(C)
    bt = rng.normal(size=(C,)) * 0.1
    wbn = rng.uniform(-1.5, 1.5, size=(C,))
    bbn = rng.normal(size=(C,)) * 0.1
    args = (x, wqk, wv, bv, wt, bt, wbn, bbn)
    want = jax_block_eval(*to_jax(*args), scale, double_norm, True)
    got = pct_block_eval(*(torch.from_numpy(a) for a in args), scale=scale,
                         double_norm=double_norm)
    _close([got], [want], f"pct_block_eval scale={scale}")


def test_pct_tail_matches_jax(x64):
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(O, P, C)) for _ in range(4)]
    w = rng.normal(size=(4 * C, K)) / np.sqrt(4 * C)
    m = _mask(rng)
    want = pct_tail_fused(*to_jax(*xs, w, m), True)
    got = pct_tail(*(torch.from_numpy(a) for a in (*xs, w, m)))
    _close(got, want, "pct_tail")
