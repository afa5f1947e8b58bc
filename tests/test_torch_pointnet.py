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
* bfloat16 forward and backward against the Pallas kernels: both round h1,
  h2 and the gradients at the same points, but sum in f32 in another order,
  so a value may land on the neighbouring bf16 number: normwise 2e-2
  (max |error| / max |value| per output; one bf16 step is 2^-8 = 3.9e-3
  relative and a flipped relu mask moves a gradient sum by a little more).
  The backward gets the JAX forward's argmax on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.ops import pointnet_fused as jpf
from sgaligner_tpu_torch.ops.pointnet_fused import (pointnet_bwd, pointnet_fused,
                                                    pointnet_fwd, stack_plain)
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
    _, amax_j = jpf._forward(xj, *wj, True, with_argmax=True)
    want = jpf._bwd_rule(True, (xj, *wj, amax_j), doutj)
    assert not np.asarray(want[0].astype(jnp.float32)).any()
    got = pointnet_bwd(*_torch([x], torch.bfloat16),
                       *_torch([dout], torch.bfloat16),
                       torch.from_numpy(np.array(amax_j)),
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
    grads = pointnet_bwd(args[0], torch.from_numpy(dout), amax, *args[1:])
    assert not bool(grads[5][0][dead.all(dim=0)].any())
