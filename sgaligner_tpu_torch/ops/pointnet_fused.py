"""PointNet encoder op (parity mode): conv1x1 -> relu (x3) -> max-pool.

Counterpart of ``sgaligner_tpu/ops/pointnet_fused.py``:

* ``pointnet_fwd(x, w1, b1, w2, b2, w3, b3, with_argmax)``: channel-first
  points ``[O, 3, P]`` -> ``out [O, C3]`` in x's dtype and, with the flag,
  ``amax [O, C3]`` int32, the first point index of each channel's max (what
  the training backward routes the gradient to); ``pointnet_pool`` gives
  the same max before its cast (``peak``, at the accumulation dtype);
* ``pointnet_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3)``: the weight
  and bias gradients ``(dw1, db1, dw2, db2, dw3, db3)``, float32 (float64
  for float64 inputs). Channel c of object o carries ``dout[o, c]`` to its
  point ``amax[o, c]`` where the forward's ``peak[o, c] > 0`` (a NaN max
  carries nothing): the JAX kernel's ``a3 > 0`` at the argmax, which is
  the forward's own test there because its forward and backward share
  ``_stack_from_cf``. Points are data: there is no gradient for x;
* ``PointNetFused``: the ``torch.autograd.Function`` of the two (its x
  gradient is zero; it keeps the forward's peak for the backward), and
  ``pointnet_fused`` to call it.

Rounding points of the JAX kernel's ``_stack_from_cf``: every product
accumulates in f32 (f64 for f64 inputs) and takes its bias there; the relu
masks come from those pre-activations; h1 and h2 are rounded to the compute
dtype; a3 stays f32 and the max and argmax run on relu(a3); the output is
rounded to the compute dtype at the end.

A CUDA tensor goes through the kernels of ``csrc/pointnet.cu`` (float32:
register-tiled FMA, W2 and W3 resident, any C3; the backward over the
routed points only) or the Hopper designs (bfloat16): the forward
``csrc/pointnet_sm90.cu``, which takes C3 = 128 or a multiple of 256, and
the backward ``csrc/pointnet_bwd_sm90.cu``, which runs over the routed
points only and takes multiples of 16. At bfloat16 the forward's wrapper
pads W3 and b3 with zero channels to the next width its kernel takes and
drops them from the output: a zero channel's max is relu(0) = 0 and never
mixes into a real channel; ``padded_bwd`` pads W3, b3, dout and peak with
zero channels (a channel whose max is not positive is never routed) and
amax with point 0, and drops dW3's and db3's padded columns. A CPU tensor
goes through the plain versions below, at any C3. The forward is the
custom op ``sgaligner::pointnet_pool`` (with the argmax,
``sgaligner::pointnet_pool_argmax``; ``ops/library.py``), which
``torch.export`` keeps whole, the padding inside its CUDA body.
"""

from __future__ import annotations

import functools

import torch

from sgaligner_tpu_torch.ops import _build, library
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


def pointnet_pool_plain(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    """``(peak [O, C3] at the accumulation dtype, amax or None)``."""
    a3, _ = stack_plain(x, w1, b1, w2, b2, w3, b3)
    h3 = torch.relu(a3)
    # torch.argmax returns the first index of the max, as jnp.argmax does
    amax = h3.argmax(dim=1).to(torch.int32) if with_argmax else None
    return h3.amax(dim=1), amax


def pointnet_fwd_plain(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    peak, amax = pointnet_pool_plain(x, w1, b1, w2, b2, w3, b3, with_argmax)
    return peak.to(x.dtype), amax


def pointnet_bwd_plain(x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """The dense backward: every point recomputed, g3 zero but at the
    routed (point, channel) pairs."""
    acc, dt = acc_dtype(x.dtype), x.dtype
    _, (m1, h1, m2, h2) = stack_plain(x, w1, b1, w2, b2, w3, b3)
    p = x.shape[-1]
    picked = (torch.arange(p, device=x.device)[None, :, None]
              == amax.long()[:, None, :])
    zero = torch.zeros((), dtype=acc, device=x.device)
    g3 = torch.where(picked & (peak > 0)[:, None, :], dout.to(acc)[:, None, :],
                     zero).to(dt)
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
    if c3 == 0:
        raise ValueError(f"{name}: C3 = 0 channels")
    for key, t, shape in (("w1", w1, (3, C1)), ("b1", b1, (1, C1)),
                          ("w2", w2, (C1, C2)), ("b2", b2, (1, C2)),
                          ("w3", w3, (C2, c3)), ("b3", b3, (1, c3))):
        _build.check_shape(name, key, t, shape)
    return o, p, c3


def padded_width(c3: int) -> int:
    """The width the bfloat16 forward kernel runs for C3 channels: 128
    channels or groups of 256 (the float32 kernel takes any C3)."""
    return 128 if c3 <= 128 else -(-c3 // 256) * 256


def pointnet_fwd(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    """x [O, 3, P]; w1 [3, 64], w2 [64, 128], w3 [128, C3]; biases [1, C];
    all in the compute dtype. Returns ``(out [O, C3] in x's dtype, amax
    [O, C3] int32 or None)``."""
    peak, amax = pointnet_pool(x, w1, b1, w2, b2, w3, b3, with_argmax)
    return peak.to(x.dtype), amax


def pointnet_pool(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    """``pointnet_fwd`` with its max before the cast: ``(peak [O, C3] at
    the accumulation dtype (float32 on the card), amax or None)``, through
    the ops ``sgaligner::pointnet_pool`` and ``pointnet_pool_argmax``."""
    if with_argmax:
        return tuple(_pool_argmax_op(x, w1, b1, w2, b2, w3, b3))
    return _pool_op(x, w1, b1, w2, b2, w3, b3), None


def _pool_cuda(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    name = "pointnet_fwd"
    o, p, c3 = _check(name, x, (w1, b1, w2, b2, w3, b3))
    width = padded_width(c3) if x.dtype == torch.bfloat16 else c3
    if width != c3:
        w3 = torch.nn.functional.pad(w3, (0, width - c3))
        b3 = torch.nn.functional.pad(b3, (0, width - c3))
    out = torch.empty((o, width), dtype=torch.float32, device=x.device)
    amax = (torch.empty((o, width), dtype=torch.int32, device=x.device)
            if with_argmax else None)
    if o:
        _build.launch(name, "sga_pointnet_fwd", x.device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                      b3.data_ptr(), out.data_ptr(),
                      amax.data_ptr() if with_argmax else None, o, p, width,
                      _build.DTYPE_CODE[x.dtype])
    if width != c3:
        out = out[:, :c3].contiguous()
        amax = amax[:, :c3].contiguous() if with_argmax else None
    return (out, amax) if with_argmax else out


def _pool_fake(x, w1, b1, w2, b2, w3, b3, with_argmax=False):
    shape = (x.shape[0], w3.shape[-1])
    peak = x.new_empty(shape, dtype=acc_dtype(x.dtype))
    return (peak, x.new_empty(shape, dtype=torch.int32)) if with_argmax else peak


_POOL_ARGS = ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
              "Tensor b3)")
_pool_op = library.define(
    "pointnet_pool", _POOL_ARGS + " -> Tensor",
    library.first(pointnet_pool_plain), _pool_cuda, _pool_fake)
_pool_argmax_op = library.define(
    "pointnet_pool_argmax", _POOL_ARGS + " -> (Tensor, Tensor)",
    *(library.flagged(f) for f in (pointnet_pool_plain, _pool_cuda, _pool_fake)))


# the flat gradient buffer of the last pointnet_bwd launch: its last float
# is the count of 64-row tiles the kernels ran (read it after the call;
# keeping it costs no sync)
last_bwd_grads: torch.Tensor | None = None


@functools.lru_cache(maxsize=64)
def _bwd_sizes(o, p, c3, dtype, device):
    """(gradient buffer floats, work buffer bytes) of one backward launch:
    one byte buffer holds the kernels' per-block slices, the routed rows'
    h2 and the slots (float32 also W3ᵀ)."""
    lib = _build.lib()
    if not o:
        return lib.sga_pointnet_grad_total(c3), 0
    with torch.cuda.device(device):
        size = lib.sga_pointnet_bwd_work_bytes(o, p, c3, _build.DTYPE_CODE[dtype])
    if size < 0:
        raise RuntimeError(f"pointnet_bwd: {lib.sga_error_string(-size).decode()}")
    return lib.sga_pointnet_grad_total(c3), size


BWD_MULTIPLE = 16   # the bfloat16 backward kernel's channel tile


def padded_bwd(bwd, width, x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """``bwd`` (the kernels' launch, or the plain backward) run at ``width``
    >= C3 channels: W3, b3, dout and peak padded with zero channels (a
    channel whose max is not positive is never routed, so the padding
    carries no gradient), amax with point 0 (any index in range); dW3's and
    db3's padded columns dropped."""
    c3 = w3.shape[-1]
    if width == c3:
        return bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3)

    def pad(t):
        return torch.nn.functional.pad(t, (0, width - c3))

    dw1, db1, dw2, db2, dw3, db3 = bwd(x, pad(dout), pad(amax), pad(peak),
                                       w1, b1, w2, b2, pad(w3), pad(b3))
    return dw1, db1, dw2, db2, dw3[:, :c3].contiguous(), db3[:, :c3].contiguous()


def pointnet_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """Weight and bias gradients of ``pointnet_fwd`` for the cotangent
    ``dout [O, C3]`` (x's dtype), routed to the points ``amax [O, C3]``
    where the forward's max ``peak [O, C3]`` (``pointnet_pool``; float32
    on the card) is positive: ``(dw1 [3, 64], db1 [1, 64], dw2, db2, dw3,
    db3)`` at f32 (f64 for f64 inputs). On the card a bfloat16 C3 that is
    not a multiple of BWD_MULTIPLE runs padded (``padded_bwd``)."""
    if x.device.type == "cpu":
        return pointnet_bwd_plain(x, dout, amax, peak, w1, b1, w2, b2, w3, b3)
    name = "pointnet_bwd"
    o, p, c3 = _check(name, x, (w1, b1, w2, b2, w3, b3))
    _build.check_cuda(name, {"x": x, "dout": dout, "amax": amax, "peak": peak})
    if (dout.dtype != x.dtype or amax.dtype != torch.int32
            or peak.dtype != torch.float32):
        raise ValueError(f"{name}: dout is {dout.dtype} (expected {x.dtype}), "
                         f"amax {amax.dtype} (expected torch.int32), peak "
                         f"{peak.dtype} (expected torch.float32)")
    for key, t in (("dout", dout), ("amax", amax), ("peak", peak)):
        _build.check_shape(name, key, t, (o, c3))
    if x.dtype == torch.float32:
        return _launch_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3)
    width = -(-c3 // BWD_MULTIPLE) * BWD_MULTIPLE
    return padded_bwd(_launch_bwd, width, x, dout, amax, peak, w1, b1, w2, b2, w3, b3)


def _launch_bwd(x, dout, amax, peak, w1, b1, w2, b2, w3, b3):
    """One launch of the backward kernels (bfloat16: C3 a multiple of
    BWD_MULTIPLE; inputs checked by ``pointnet_bwd``). b3 takes no part:
    the routing reads the forward's max."""
    global last_bwd_grads
    name = "pointnet_bwd"
    o, p, c3 = x.shape[0], x.shape[-1], w3.shape[-1]
    total, size = _bwd_sizes(o, p, c3, x.dtype, x.device)
    # the kernels' slice sums write every entry
    grads = (torch.empty if o else torch.zeros)(total, dtype=torch.float32, device=x.device)
    if o:
        work = torch.empty(size, dtype=torch.uint8, device=x.device)
        _build.launch(name, "sga_pointnet_bwd", x.device,
                      x.data_ptr(), dout.data_ptr(), amax.data_ptr(),
                      peak.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                      work.data_ptr(), grads.data_ptr(), o, p, c3,
                      _build.DTYPE_CODE[x.dtype])
    last_bwd_grads = grads
    sizes = (3 * C1, C1, C1 * C2, C2, C2 * c3, c3)
    shapes = ((3, C1), (1, C1), (C1, C2), (1, C2), (C2, c3), (1, c3))
    return tuple(g.view(s) for g, s in zip(torch.split(grads[:-1], sizes), shapes))


class PointNetFused(torch.autograd.Function):
    """Forward with the argmax output; backward through ``pointnet_bwd``,
    routed by the forward's own max (kept at the accumulation dtype). The
    gradient of x is zero by design (points are data)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        peak, amax = pointnet_pool(x, w1, b1, w2, b2, w3, b3, with_argmax=True)
        ctx.save_for_backward(x, amax, peak, w1, b1, w2, b2, w3, b3)
        return peak.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, amax, peak, *weights = ctx.saved_tensors
        grads = pointnet_bwd(x, dout.contiguous(), amax, peak, *weights)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return (dx, *(g.to(w.dtype) for g, w in zip(grads, weights)))


def pointnet_fused(x, w1, b1, w2, b2, w3, b3):
    """Differentiable ``pointnet_fwd(...)[0]`` (see ``PointNetFused``)."""
    return PointNetFused.apply(x, w1, b1, w2, b2, w3, b3)
