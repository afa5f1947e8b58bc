"""The port's PointNet op (plain versions, CPU) against the JAX package's
``pointnet_fused`` with its Pallas kernels in interpret mode.

O=16 objects of P=32 points, C3=256 (the op's widths are fixed at 64 and
128 before it), inputs from numpy with a fixed seed.

* float64 forward against the unfused f64 composition ``_unfused``: rtol
  1e-12 / atol 1e-12 (the same f64 sums in another order). Against the
  Pallas forward ``_forward(..., with_argmax=True)``: atol 1e-6, because
  that kernel accumulates in f32 and writes an f32 output whatever the
  input dtype (``preferred_element_type=jnp.float32``, ``out_shape``
  float32), where the port accumulates f64 inputs in f64. Its argmax must
  equal the port's, or point at a value within 1e-6 of the port's max.
  That f32 step is inside the JAX function: the output is cast back to
  float64, so the dtype guard (``expect_dtype``) passes it like the others
  and the 1e-6 tolerance is what records it.
* float64 gradients against the JAX backward, which at itemsize > 2 is
  ``jax.grad`` of the unfused composition (its tile picker gives the Pallas
  backward no tile there): rtol 1e-10 / atol 1e-12.
* float32 forward with a tie across a 64-point boundary (point 70 repeats
  point 5) and a NaN point, against the Pallas forward: both take the
  first index on the tie and a NaN wins every channel at its first point;
  the values normwise within 1e-5 (f32 sums in another order).
* bfloat16 forward and backward against the Pallas kernels: both round h1,
  h2 and the gradients at the same points, but sum in f32 in another order,
  so a value may land on the neighbouring bf16 number: normwise 2e-2
  (max |error| / max |value| per output; one bf16 step is 2^-8 = 3.9e-3
  relative and a flipped relu mask moves a gradient sum by a little more).
  The backward gets the JAX forward's argmax and its max (the routing
  test peak > 0) on both sides.
* The routing: the port's backward routes a channel's gradient by the
  forward's own max (peak > 0), where the JAX kernel recomputes a3 and
  tests a3 > 0 at the argmax. On the CPU the two are the same bits
  (float32, bfloat16, float64), and so are the gradients.
* The routed-rows formulation of the card's bfloat16 backward
  (``_routed_rows_bwd`` below: per object only the points some live
  channel routes to, or a NaN max marks, recomputed and multiplied)
  against the JAX ``_bwd_rule`` on its Pallas kernel in interpret mode,
  at float64 (O=8, P=64, C3=64; ``_pick_tile`` patched in the test so the
  rule takes the kernel at itemsize 8). That kernel sums in f32 whatever
  the input dtype (``preferred_element_type``), so the two are held to
  rtol 1e-5 / atol 1e-6; NaN must sit at the same places.
* The card's float32 backward (``csrc/pointnet.cu``) as a formulation
  (``_f32_routed_rows_bwd``: the same routed rows, g2 of each row from its
  own live channels in channel order, dW3 as one rank-1 column per live
  channel plus NaN where a listed row's h2 is not finite, the relu masks
  read off h) against the same Pallas ``_bwd_rule`` at float64, by the same
  rule.
* The card's float32 forward pool (``_f32_pool_model``: per 64-point tile
  eight row groups keep a running max and first index, merged at the end
  by the pool's first-index rule) at float64 against the plain forward
  (the same bits and indices) and the Pallas forward (atol 1e-6, as
  above): ties across tiles and across row groups, a NaN in either of two
  row groups and in a ragged last tile, a dead object (O=6, P=136, C3=40).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.ops import pointnet_fused as jpf
from sgaligner_tpu_torch.ops.pointnet_fused import (pointnet_bwd, pointnet_bwd_plain,
                                                    pointnet_fused, pointnet_fwd,
                                                    pointnet_pool_plain, stack_plain)
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)

O, P, C3 = 16, 32, 256
BF16_NORMWISE = 2e-2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(O, 3, P))
    ws = []
    for cin, cout in ((3, 64), (64, 128), (128, C3)):
        ws.append(rng.normal(size=(cin, cout)) / np.sqrt(cin))
        ws.append(rng.normal(size=(1, cout)) * 0.1)
    dout = rng.normal(size=(O, C3))
    return x, ws, dout


def _jax(arrays, dtype):
    return expect_dtype([jnp.asarray(a, dtype) for a in arrays], dtype,
                        what="JAX input")


def _torch(arrays, dtype):
    return [torch.from_numpy(np.asarray(a, np.float64)).to(dtype) for a in arrays]


def _normwise(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_forward_and_argmax_match_jax_f64(x64):
    x, ws, _ = _inputs(0)
    out_j, amax_j = jpf._forward(*_jax([x, *ws], jnp.float64), True,
                                 with_argmax=True)
    assert jpf._pick_tile(O, P, 8, bwd=False) is not None   # the Pallas kernel ran
    expect_dtype(out_j, what="Pallas PointNet forward (f32 inside, cast back)")
    args = _torch([x, *ws], torch.float64)
    out, amax = pointnet_fwd(*args, with_argmax=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect_dtype(jpf._unfused(
        *_jax([x, *ws], jnp.float64)))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)
    h3 = torch.relu(stack_plain(*args)[0])
    at_jax = torch.gather(h3, 1, torch.from_numpy(
        np.array(amax_j)).long()[:, None, :])[:, 0]
    assert float((out - at_jax).abs().max()) <= 1e-6
    assert float((amax.numpy() == np.asarray(amax_j)).mean()) > 0.99
    # the inference form (no argmax) gives the same values
    np.testing.assert_array_equal(
        pointnet_fwd(*_torch([x, *ws], torch.float64))[0].numpy(), out.numpy())


def test_gradients_match_jax_f64(x64):
    x, ws, dout = _inputs(1)
    xj, *wj = _jax([x, *ws], jnp.float64)
    _, vjp = jax.vjp(lambda *w: jpf.pointnet_fused(xj, *w, True), *wj)
    want = expect_dtype(vjp(*_jax([dout], jnp.float64)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    out = pointnet_fused(xt, *wt)
    got = torch.autograd.grad(out, [xt, *wt], torch.from_numpy(dout))
    assert not got[0].any()                       # points are data: dx = 0
    for i, (g, w) in enumerate(zip(got[1:], want)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=f"grad {i}")


def test_forward_matches_pallas_bf16():
    x, ws, _ = _inputs(2)
    out_j, amax_j = jpf._forward(*_jax([x, *ws], jnp.bfloat16), True,
                                 with_argmax=True)
    args = _torch([x, *ws], torch.bfloat16)
    out, amax = pointnet_fwd(*args, with_argmax=True)
    assert out.dtype == torch.bfloat16 and amax.dtype == torch.int32
    assert _normwise(out.float().numpy(),
                     np.asarray(out_j.astype(jnp.float32))) <= BF16_NORMWISE
    # near-ties are not ties: where the indices differ, the port's own
    # activation at JAX's index must equal the port's max
    h3 = torch.relu(stack_plain(*args)[0])                     # [O, P, C3]
    at_jax = torch.gather(h3, 1, torch.from_numpy(
        np.array(amax_j)).long()[:, None, :])[:, 0]
    peak = h3.amax(dim=1)
    assert float((peak - at_jax).abs().max()) <= BF16_NORMWISE * float(peak.max())
    assert float((amax.numpy() == np.asarray(amax_j)).mean()) > 0.9


def test_backward_matches_pallas_bf16():
    x, ws, dout = _inputs(3)
    xj, *wj = _jax([x, *ws], jnp.bfloat16)
    doutj = jnp.asarray(dout, jnp.bfloat16)
    assert jpf._pick_tile(O, P, 2, bwd=True) is not None   # Pallas backward
    out_j, amax_j = jpf._forward(xj, *wj, True, with_argmax=True)
    want = jpf._bwd_rule(True, (xj, *wj, amax_j), doutj)
    assert not np.asarray(want[0].astype(jnp.float32)).any()
    got = pointnet_bwd(*_torch([x], torch.bfloat16),
                       *_torch([dout], torch.bfloat16),
                       torch.from_numpy(np.array(amax_j)),
                       torch.from_numpy(np.array(out_j.astype(jnp.float32))),
                       *_torch(ws, torch.bfloat16))
    for i, (g, w) in enumerate(zip(got, want[1:])):
        assert g.dtype == torch.float32
        err = _normwise(g.numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= BF16_NORMWISE, (i, err)


@pytest.mark.parametrize("p", [32, 7])
def test_argmax_is_first_index_on_ties(p):
    """Channels whose a3 <= 0 at every point tie at 0 everywhere: their
    index is 0, and their gradient is masked to 0."""
    x, ws, dout = _inputs(4)
    ws[5] = ws[5] - 50.0                       # b3: most channels dead
    args = _torch([x[:, :, :p], *ws], torch.float64)
    out, amax = pointnet_fwd(*args, with_argmax=True)
    dead = out == 0
    assert bool(dead.any())
    assert not bool(amax[dead].any())
    grads = pointnet_bwd(args[0], torch.from_numpy(dout), amax, out, *args[1:])
    assert not bool(grads[5][0][dead.all(dim=0)].any())


def test_first_index_and_nan_match_pallas_f32():
    """Object 0 repeats point 5 at point 70 (another 64-point tile of the
    card's kernel), scaled so that many channels' max lie on that pair;
    object 2 holds a NaN at points 7 and 40. The plain forward and the
    Pallas kernel (interpret mode) agree on the values (1e-5 normwise), on
    the first index of each tie, and on the NaN: every channel of object 2
    is NaN at index 7. Elsewhere an index is held by value (the port's
    activation at JAX's index equals the port's max within 1e-5)."""
    p = 72
    _, ws, _ = _inputs(5)
    x = np.random.default_rng(6).normal(size=(O, 3, p))
    x[0, :, 5] *= 8.0
    x[0, :, 70] = x[0, :, 5]
    x[2, 0, 7] = np.nan
    x[2, 1, 40] = np.nan
    assert jpf._pick_tile(O, p, 4, bwd=False) is not None    # the Pallas kernel ran
    out_j, amax_j = jpf._forward(*_jax([x, *ws], jnp.float32), True, with_argmax=True)
    out_j, amax_j = np.asarray(out_j), np.asarray(amax_j)
    args = _torch([x, *ws], torch.float32)
    out, amax = pointnet_fwd(*args, with_argmax=True)
    out, amax = out.numpy(), amax.numpy()
    tied = (amax_j[0] == 5) | (amax_j[0] == 70)
    assert tied.mean() > 0.2
    assert (amax_j[0][tied] == 5).all() and (amax[0][tied] == 5).all()
    assert np.isnan(out[2]).all() and np.isnan(out_j[2]).all()
    assert (amax[2] == 7).all() and (amax_j[2] == 7).all()
    finite = np.arange(O) != 2
    assert _normwise(out[finite], out_j[finite]) <= 1e-5
    h3 = torch.relu(stack_plain(*args)[0])[finite]
    at_jax = torch.gather(h3, 1, torch.from_numpy(amax_j[finite]).long()[:, None, :])[:, 0]
    assert _normwise(at_jax.numpy(), out[finite]) <= 1e-5


def _edge_inputs(nan_point: bool):
    """O=8 objects of P=64 points, C3=64. Object 0 repeats point 5 at point
    40, scaled up so that many channels' max lie on the pair (an exact
    tie: the first index routes); object 3's points are scaled down and b3
    set so that every channel of it is dead (max <= 0); column 7 of dout
    is zero. With ``nan_point``, object 2 holds a NaN at points 7 (x) and
    40 (y)."""
    o, p, c3 = 8, 64, 64
    rng = np.random.default_rng(11)
    x = rng.normal(size=(o, 3, p))
    x[0, :, 5] *= 8.0
    x[0, :, 40] = x[0, :, 5]
    x[3] *= 0.05
    ws = []
    for cin, cout in ((3, 64), (64, 128), (128, c3)):
        ws.append(rng.normal(size=(cin, cout)) / np.sqrt(cin))
        ws.append(rng.normal(size=(1, cout)) * 0.1)
    h = np.maximum(x[3].T @ ws[0] + ws[1], 0.0)
    h = np.maximum(h @ ws[2] + ws[3], 0.0)
    ws[5] = -(h @ ws[4]).max(axis=0, keepdims=True) - 0.01    # object 3 dead
    if nan_point:
        x[2, 0, 7] = np.nan
        x[2, 1, 40] = np.nan
    dout = rng.normal(size=(o, c3))
    dout[:, 7] = 0.0
    return x, ws, dout


def _routed_rows_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """The card's bfloat16 backward as a formulation, at float64 in numpy:
    per object, the points that a live channel (peak > 0, dout != 0)
    routes to or a NaN max marks, in order; layers 1 and 2 on those rows
    alone; g3 holds each live channel's dout at its row; the products and
    sums over those rows (np.einsum: no BLAS, so 0·NaN stays NaN); and a
    NaN into dw1[k] where x[k] of the object is not finite (what the
    unrouted points' x·0 adds to the dense sums)."""
    o, _, p = x.shape
    c3 = w3.shape[1]
    dw1, db1 = np.zeros((3, 64)), np.zeros((1, 64))
    dw2, db2 = np.zeros((64, 128)), np.zeros((1, 128))
    dw3, db3 = np.zeros((128, c3)), np.zeros((1, c3))
    for i in range(o):
        dw1 += np.where(~np.isfinite(x[i]).all(axis=1), np.nan, 0.0)[:, None]
        live = (peak[i] > 0) & (dout[i] != 0)
        rows = np.unique(amax[i][live | np.isnan(peak[i])])
        if rows.size == 0:
            continue
        xr = x[i][:, rows].T                                    # [R, 3]
        a1 = np.einsum("rk,kd->rd", xr, w1) + b1
        h1 = np.maximum(a1, 0.0)                                # keeps a NaN
        a2 = np.einsum("rk,kd->rd", h1, w2) + b2
        h2 = np.maximum(a2, 0.0)
        g3 = np.zeros((rows.size, c3))
        chans = np.flatnonzero(live)
        g3[np.searchsorted(rows, amax[i][chans]), chans] = dout[i][chans]
        g2 = np.where(a2 > 0, np.einsum("rc,kc->rk", g3, w3), 0.0)
        g1 = np.where(a1 > 0, np.einsum("rk,dk->rd", g2, w2), 0.0)
        dw3 += np.einsum("rk,rc->kc", h2, g3)
        db3 += g3.sum(axis=0)
        dw2 += np.einsum("rk,rc->kc", h1, g2)
        db2 += g2.sum(axis=0)
        dw1 += np.einsum("rk,rc->kc", xr, g1)
        db1 += g1.sum(axis=0)
    return dw1, db1, dw2, db2, dw3, db3


def _f32_routed_rows_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """The card's float32 backward as a formulation, at float64 in numpy:
    the routed rows of ``_routed_rows_bwd``, layers 1 and 2 on them; g2 of
    each row from the live channels routed to it alone, dout·W3ᵀ[c] added
    in channel order, masked by h2 > 0 (relu keeps a NaN, so h > 0 is
    a > 0); g1 masked by h1 > 0; dW3 as one rank-1 column per live channel
    (h2 at its row times its dout), and NaN in every column of a k whose h2
    is not finite on a listed row (the dense product's 0·NaN); the other
    sums over the listed rows; NaN into dw1[k] where x[k] of the object is
    not finite."""
    o, _, p = x.shape
    c3 = w3.shape[1]
    dw1, db1 = np.zeros((3, 64)), np.zeros((1, 64))
    dw2, db2 = np.zeros((64, 128)), np.zeros((1, 128))
    dw3, db3 = np.zeros((128, c3)), np.zeros((1, c3))
    for i in range(o):
        dw1 += np.where(~np.isfinite(x[i]).all(axis=1), np.nan, 0.0)[:, None]
        live = (peak[i] > 0) & (dout[i] != 0)
        rows = np.unique(amax[i][live | np.isnan(peak[i])])
        if rows.size == 0:
            continue
        xr = x[i][:, rows].T                                    # [R, 3]
        h1 = np.maximum(np.einsum("rk,kd->rd", xr, w1) + b1, 0.0)
        h2 = np.maximum(np.einsum("rk,kd->rd", h1, w2) + b2, 0.0)
        chans = np.flatnonzero(live)
        slots = np.searchsorted(rows, amax[i][chans])
        g2 = np.zeros((rows.size, 128))
        for c, s_ in zip(chans, slots):
            g2[s_] += dout[i][c] * w3[:, c]
        g2 = np.where(h2 > 0, g2, 0.0)
        g1 = np.where(h1 > 0, np.einsum("rk,dk->rd", g2, w2), 0.0)
        dw3[:, chans] += h2[slots].T * dout[i][chans]
        dw3[~np.isfinite(h2).all(axis=0)] += np.nan
        db3[0, chans] += dout[i][chans]
        dw2 += np.einsum("rk,rc->kc", h1, g2)
        db2 += g2.sum(axis=0)
        dw1 += np.einsum("rk,rc->kc", xr, g1)
        db1 += g1.sum(axis=0)
    return dw1, db1, dw2, db2, dw3, db3


def _pallas_bwd_f64(monkeypatch, nan_point):
    """``_edge_inputs`` through JAX's forward and ``_bwd_rule`` on the
    Pallas kernels at float64 in interpret mode: (x, ws, dout, the
    gradients, amax, peak)."""
    x, ws, dout = _edge_inputs(nan_point)
    # the Pallas backward at float64: one tile of every object (the JAX
    # package picks no tile above itemsize 2 and takes jax.grad of the
    # unfused stack instead, which splits the max's gradient over ties)
    monkeypatch.setattr(jpf, "_pick_tile", lambda o_, p_, itemsize, bwd: o_)
    xj, *wj = _jax([x, *ws], jnp.float64)
    out_j, amax_j = jpf._forward(xj, *wj, True, with_argmax=True)
    want = expect_dtype(jpf._bwd_rule(True, (xj, *wj, amax_j), _jax([dout], jnp.float64)[0]))
    amax, peak = np.asarray(amax_j), np.asarray(out_j)
    dead = peak[3] <= 0
    assert dead.all() and (amax[0] == 5).mean() > 0.2
    if nan_point:
        assert np.isnan(peak[2]).all() and (amax[2] == 7).all()
        assert np.isnan(np.asarray(want[1])).any()
    return x, ws, dout, want, amax, peak


@pytest.mark.parametrize("nan_point", [False, True], ids=["ties_dead_zero_dout", "nan_point"])
def test_routed_rows_match_pallas_bwd_rule_f64(x64, monkeypatch, nan_point):
    x, ws, dout, want, amax, peak = _pallas_bwd_f64(monkeypatch, nan_point)
    got = _routed_rows_bwd(x, dout, amax, peak, *ws)
    for i, (g, w) in enumerate(zip(got, want[1:])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=f"grad {i}")


@pytest.mark.parametrize("nan_point", [False, True], ids=["ties_dead_zero_dout", "nan_point"])
def test_f32_routed_rows_match_pallas_bwd_rule_f64(x64, monkeypatch, nan_point):
    """The float32 kernels' formulation: the same rule as the bfloat16
    one's (NaN at the same places as the dense Pallas sums)."""
    x, ws, dout, want, amax, peak = _pallas_bwd_f64(monkeypatch, nan_point)
    got = _f32_routed_rows_bwd(x, dout, amax, peak, *ws)
    for i, (g, w) in enumerate(zip(got, want[1:])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=f"grad {i}")


def _f32_pool_model(h3):
    """The card's float32 forward pool as a formulation, in numpy: per
    64-point tile each of eight row groups (points 4g..4g+3 and
    32+4g..32+4g+3 of the tile) runs over its points in ascending order, a
    strictly greater value or a first NaN replacing its running max and
    index; then the groups merge in group order by the pool's first-index
    rule (beats_max: larger, or equal at an earlier index; a NaN beats any
    number and a later NaN). h3 [O, P, C], relu'd. Returns (max, index),
    each [O, C]."""
    o, p, c = h3.shape
    best = np.full((8, o, c), -np.inf)
    idx = np.zeros((8, o, c), np.int64)
    for r0 in range(0, p, 64):
        for g in range(8):
            for i in range(8):
                row = r0 + (4 * g + i if i < 4 else 28 + 4 * g + i)
                if row >= p:
                    continue
                v = h3[:, row]
                upd = ~np.isnan(best[g]) & ((v > best[g]) | np.isnan(v))
                best[g] = np.where(upd, v, best[g])
                idx[g] = np.where(upd, row, idx[g])
    out, at = best[0], idx[0]
    for g in range(1, 8):
        v, i = best[g], idx[g]
        nan_v, nan_o = np.isnan(v), np.isnan(out)
        beats = np.where(nan_v, ~nan_o | (i < at),
                         ~nan_o & ((v > out) | ((v == out) & (i < at))))
        out, at = np.where(beats, v, out), np.where(beats, i, at)
    return out, at


def test_f32_forward_split_pool_matches_pallas_f64(x64):
    """Object 0 repeats point 5 at point 70 (row group 1 of tiles 0 and 1),
    object 1 point 9 at point 45 (row groups 2 and 3 of tile 0), each
    scaled so that many channels' max lie on the pair; object 2 holds a
    NaN at points 50 (group 4) and 20 (group 5): every channel's max is
    NaN at 20; object 3 a NaN at point 130 (the ragged third tile); object
    4's points are scaled down and b3 set so that it is dead (every max 0,
    at point 0). The model equals the plain forward (values and indices)
    and agrees with the Pallas forward: values within 1e-6, the first index
    of each tie, the NaN's index, and elsewhere the index held by value."""
    o, p, c3 = 6, 136, 40
    rng = np.random.default_rng(12)
    x = rng.normal(size=(o, 3, p))
    ws = []
    for cin, cout in ((3, 64), (64, 128), (128, c3)):
        ws.append(rng.normal(size=(cin, cout)) / np.sqrt(cin))
        ws.append(rng.normal(size=(1, cout)) * 0.1)
    x[0, :, 5] *= 8.0
    x[0, :, 70] = x[0, :, 5]
    x[1, :, 9] *= 8.0
    x[1, :, 45] = x[1, :, 9]
    x[4] *= 0.05
    h = np.maximum(x[4].T @ ws[0] + ws[1], 0.0)
    h = np.maximum(h @ ws[2] + ws[3], 0.0)
    ws[5] = -(h @ ws[4]).max(axis=0, keepdims=True) - 0.01    # object 4 dead
    x[2, 0, 50] = np.nan
    x[2, 1, 20] = np.nan
    x[3, 2, 130] = np.nan
    assert jpf._pick_tile(o, p, 8, bwd=False) is not None      # the Pallas kernel ran
    out_j, amax_j = jpf._forward(*_jax([x, *ws], jnp.float64), True, with_argmax=True)
    out_j, amax_j = np.asarray(expect_dtype(out_j)), np.asarray(amax_j)
    args = _torch([x, *ws], torch.float64)
    h3 = torch.relu(stack_plain(*args)[0])
    out, at = _f32_pool_model(h3.numpy())
    peak, amax = pointnet_pool_plain(*args, with_argmax=True)
    np.testing.assert_array_equal(out, peak.numpy())
    np.testing.assert_array_equal(at, amax.numpy())
    for obj, first, second in ((0, 5, 70), (1, 9, 45)):
        tied = (amax_j[obj] == first) | (amax_j[obj] == second)
        assert tied.mean() > 0.2
        assert (amax_j[obj][tied] == first).all() and (at[obj][tied] == first).all()
    for obj, row in ((2, 20), (3, 130)):
        assert np.isnan(out[obj]).all() and np.isnan(out_j[obj]).all()
        assert (at[obj] == row).all() and (amax_j[obj] == row).all()
    assert (out[4] == 0).all() and (at[4] == 0).all() and (amax_j[4] == 0).all()
    finite = np.array([0, 1, 4, 5])
    np.testing.assert_allclose(out[finite], out_j[finite], rtol=0, atol=1e-6)
    at_jax = np.take_along_axis(h3.numpy()[finite], amax_j[finite][:, None, :], axis=1)[:, 0]
    np.testing.assert_allclose(at_jax, out[finite], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_forward_max_routes_as_the_recompute(dtype):
    """peak > 0 (the forward's max) is a3 > 0 at the argmax of the plain
    recompute, bit for bit, and the backward gives the same bits routed
    either way (ties, a NaN point, a dead object, a zero dout column)."""
    x, ws, dout = _edge_inputs(nan_point=True)
    args = _torch([x, *ws], dtype)
    peak, amax = pointnet_pool_plain(*args, with_argmax=True)
    a3 = stack_plain(*args)[0]
    at = torch.gather(a3, 1, amax.long()[:, None, :])[:, 0]
    assert torch.equal(peak > 0, at > 0)
    assert bool((peak > 0).any()) and not bool((peak > 0).all())
    dout_t = _torch([dout], dtype)[0]
    by_peak = pointnet_bwd(args[0], dout_t, amax, peak, *args[1:])
    by_recompute = pointnet_bwd_plain(args[0], dout_t, amax, at, *args[1:])
    for g, r in zip(by_peak, by_recompute):
        assert torch.equal(g.nan_to_num(7.0), r.nan_to_num(7.0))


def test_autograd_matches_jax_grads_f64_dead_and_zero_dout(x64):
    """PointNetFused (the forward's peak kept for the backward) against
    JAX's gradients at float64 on inputs with a dead object and a zero
    dout column (no NaN, and the tie moved apart: JAX's float64 backward
    is jax.grad of the unfused stack, which splits a tie)."""
    x, ws, dout = _edge_inputs(nan_point=False)
    x[0, :, 40] += 1e-3
    xj, *wj = _jax([x, *ws], jnp.float64)
    _, vjp = jax.vjp(lambda *w: jpf.pointnet_fused(xj, *w, True), *wj)
    want = expect_dtype(vjp(*_jax([dout], jnp.float64)))
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    out = pointnet_fused(torch.from_numpy(x), *wt)
    got = torch.autograd.grad(out, wt, torch.from_numpy(dout))
    assert not bool(got[5][0, 7].any())          # the zero column routes nothing
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=f"grad {i}")
