"""PointNet encoder op (parity mode): conv1x1 -> relu (x3) -> max-pool.

Counterpart of ``sgaligner_tpu/ops/pointnet_fused.py``:

* ``pointnet_fwd(x, w1, b1, w2, b2, w3, b3, with_argmax)``: channel-first
  points ``[O, 3, P]`` -> ``out [O, C3]`` in x's dtype and, with the flag,
  ``amax [O, C3]`` int32, the first point index of each channel's max (what
  the training backward routes the gradient to);
* ``pointnet_bwd(x, dout, amax, w1, b1, w2, b2, w3, b3)``: the weight and
  bias gradients ``(dw1, db1, dw2, db2, dw3, db3)``, float32 (float64 for
  float64 inputs). Points are data: there is no gradient for x;
* ``PointNetFused``: the ``torch.autograd.Function`` of the two (its x
  gradient is zero), and ``pointnet_fused`` to call it.

Rounding points of the JAX kernel's ``_stack_from_cf``: every product
accumulates in f32 (f64 for f64 inputs) and takes its bias there; the relu
masks come from those pre-activations; h1 and h2 are rounded to the compute
dtype; a3 stays f32 and the max and argmax run on relu(a3); the output is
rounded to the compute dtype at the end.

A CUDA tensor goes through ``csrc/pointnet.cu`` (float32 and bfloat16); a CPU
tensor through the plain versions below.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build
from sgaligner_tpu_torch.ops.pct_embed import acc_dtype

C1, C2 = 64, 128


def stack_plain(x, w1, b1, w2, b2, w3, b3):
    """x [O, 3, P] -> (a3 [O, P, C3] at the accumulation dtype,
    (m1, h1, m2, h2))."""
    acc, dt = acc_dtype(x.dtype), x.dtype
    a1 = torch.matmul(x.to(acc).transpose(1, 2), w1.to(acc)) + b1.to(acc)
    h1 = torch.relu(a1).to(dt)
    a2 = torch.matmul(h1.to(acc), w2.to(acc)) + b2.to(acc)
    h2 = torch.relu(a2).to(dt)
    a3 = torch.matmul(h2.to(acc), w3.to(acc)) + b3.to(acc)
    return a3, (a1 > 0, h1, a2 > 0, h2)


def pointnet_fwd_plain(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    a3, _ = stack_plain(x, w1, b1, w2, b2, w3, b3)
    h3 = torch.relu(a3)
    out = h3.amax(dim=1).to(x.dtype)
    # torch.argmax returns the first index of the max, as jnp.argmax does
    amax = h3.argmax(dim=1).to(torch.int32) if with_argmax else None
    return out, amax


def pointnet_bwd_plain(x, dout, amax, w1, b1, w2, b2, w3, b3):
    acc, dt = acc_dtype(x.dtype), x.dtype
    a3, (m1, h1, m2, h2) = stack_plain(x, w1, b1, w2, b2, w3, b3)
    p = x.shape[-1]
    picked = (torch.arange(p, device=x.device)[None, :, None]
              == amax.long()[:, None, :])
    zero = torch.zeros((), dtype=acc, device=x.device)
    g3 = torch.where(picked & (a3 > 0), dout.to(acc)[:, None, :], zero).to(dt)
    g2 = torch.where(m2, torch.matmul(g3.to(acc), w3.to(acc).t()), zero).to(dt)
    g1 = torch.where(m1, torch.matmul(g2.to(acc), w2.to(acc).t()), zero).to(dt)

    def wg(h, g):   # Σ over objects and points of hᵀ·g
        return torch.einsum("opc,opd->cd", h.to(acc), g.to(acc))

    def bg(g):
        return g.to(acc).sum(dim=(0, 1))[None]

    dw1 = torch.einsum("okp,opd->kd", x.to(acc), g1.to(acc))
    return dw1, bg(g1), wg(h1, g2), bg(g2), wg(h2, g3), bg(g3)


def _check(name, x, weights):
    w1, b1, w2, b2, w3, b3 = weights
    _build.check_cuda(name, {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
                             "w3": w3, "b3": b3}, x.dtype)
    o, three, p = x.shape
    c3 = w3.shape[-1]
    if three != 3:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected [O, 3, P]")
    if c3 % 16 or c3 == 0:
        raise ValueError(f"{name}: C3 = {c3} is not a positive multiple of 16")
    for key, t, shape in (("w1", w1, (3, C1)), ("b1", b1, (1, C1)),
                          ("w2", w2, (C1, C2)), ("b2", b2, (1, C2)),
                          ("w3", w3, (C2, c3)), ("b3", b3, (1, c3))):
        _build.check_shape(name, key, t, shape)
    return o, p, c3


def pointnet_fwd(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    """x [O, 3, P]; w1 [3, 64], w2 [64, 128], w3 [128, C3]; biases [1, C];
    all in the compute dtype. Returns ``(out [O, C3] in x's dtype, amax
    [O, C3] int32 or None)``."""
    if x.device.type == "cpu":
        return pointnet_fwd_plain(x, w1, b1, w2, b2, w3, b3, with_argmax)
    name = "pointnet_fwd"
    o, p, c3 = _check(name, x, (w1, b1, w2, b2, w3, b3))
    out = torch.empty((o, c3), dtype=torch.float32, device=x.device)
    amax = (torch.empty((o, c3), dtype=torch.int32, device=x.device)
            if with_argmax else None)
    if o:
        _build.launch(name, "sga_pointnet_fwd", x.device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                      b3.data_ptr(), out.data_ptr(),
                      amax.data_ptr() if with_argmax else None, o, p, c3,
                      _build.DTYPE_CODE[x.dtype])
    return out.to(x.dtype), amax


def pointnet_bwd(x, dout, amax, w1, b1, w2, b2, w3, b3):
    """Weight and bias gradients of ``pointnet_fwd`` for the cotangent
    ``dout [O, C3]`` (x's dtype), routed to the points ``amax [O, C3]``:
    ``(dw1 [3, 64], db1 [1, 64], dw2, db2, dw3, db3)`` at f32 (f64 for f64
    inputs)."""
    if x.device.type == "cpu":
        return pointnet_bwd_plain(x, dout, amax, w1, b1, w2, b2, w3, b3)
    name = "pointnet_bwd"
    o, p, c3 = _check(name, x, (w1, b1, w2, b2, w3, b3))
    _build.check_cuda(name, {"x": x, "dout": dout, "amax": amax})
    if dout.dtype != x.dtype or amax.dtype != torch.int32:
        raise ValueError(f"{name}: dout is {dout.dtype} (expected {x.dtype}), "
                         f"amax is {amax.dtype} (expected torch.int32)")
    _build.check_shape(name, "dout", dout, (o, c3))
    _build.check_shape(name, "amax", amax, (o, c3))
    lib = _build.lib()
    total = lib.sga_pointnet_grad_total(c3)
    grads = torch.zeros(total, dtype=torch.float32, device=x.device)
    if o:
        with torch.cuda.device(x.device):
            blocks = lib.sga_pointnet_bwd_blocks(o, c3, _build.DTYPE_CODE[x.dtype])
        if blocks < 0:
            raise RuntimeError(f"{name}: {lib.sga_error_string(-blocks).decode()}")
        scratch = torch.empty((blocks, lib.sga_pointnet_grad_stride(c3)),
                              dtype=torch.float32, device=x.device)
        _build.launch(name, "sga_pointnet_bwd", x.device,
                      x.data_ptr(), dout.data_ptr(), amax.data_ptr(),
                      w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                      b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                      scratch.data_ptr(), blocks, grads.data_ptr(), o, p, c3,
                      _build.DTYPE_CODE[x.dtype])
    sizes = (3 * C1, C1, C1 * C2, C2, C2 * c3, c3)
    shapes = ((3, C1), (1, C1), (C1, C2), (1, C2), (C2, c3), (1, c3))
    return tuple(g.view(s) for g, s in zip(torch.split(grads, sizes), shapes))


class PointNetFused(torch.autograd.Function):
    """Forward with the argmax output; backward through ``pointnet_bwd``.
    The gradient of x is zero by design (points are data)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        out, amax = pointnet_fwd(x, w1, b1, w2, b2, w3, b3, with_argmax=True)
        ctx.save_for_backward(x, amax, w1, b1, w2, b2, w3, b3)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, amax, *weights = ctx.saved_tensors
        grads = pointnet_bwd(x, dout.contiguous(), amax, *weights)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return (dx, *(g.to(w.dtype) for g, w in zip(grads, weights)))


def pointnet_fused(x, w1, b1, w2, b2, w3, b3):
    """Differentiable ``pointnet_fwd(...)[0]`` (see ``PointNetFused``)."""
    return PointNetFused.apply(x, w1, b1, w2, b2, w3, b3)
