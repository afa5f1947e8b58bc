"""PCT tail: concat(4 SA outputs) -> 1024-wide projection -> pool, forward
and backward.

Counterpart of ``sgaligner_tpu/ops/pct_tail.py::pct_tail_fused`` and its
custom VJP with the forward-saved indices (``SGA_TAIL_FWD_IDX``, on by
default there):

* ``pct_tail``: the per-object, per-channel max and min of
  ``z = concat(x) @ w`` over points and the masked BN sums of z; with
  ``with_index`` also the int32 first-index argmax / argmin of z (what the
  training backward routes the pool gradient to). The caller rebuilds the
  reference's BN -> LeakyReLU -> max-pool with the exact monotone identity
  ``max_p leaky(w·z_p + b) = leaky(w·(max_p z if w > 0 else min_p z) + b)``.
* ``pct_tail_bwd``: the backward (Pallas kernel ``_bwd_kernel_idx``): the pool
  cotangents routed to the saved rows plus the dense BN term
  ``m·(dssum + 2 z dssumsq)``, then ``dx_i = g·W_iᵀ`` and ``dW = Σ xᵀ·g``.
* ``PctTail``: the ``torch.autograd.Function`` NaivePCT trains through.

A CUDA tensor goes through ``csrc/pct_tail.cu`` (bf16 through the wgmma
designs of ``csrc/pct_tail_sm90.cu`` and, the backward,
``csrc/pct_tail_bwd_sm90.cu``); a CPU tensor through the plain versions.
The forward is the custom op ``sgaligner::pct_tail`` (with the indices,
``sgaligner::pct_tail_indexed``; ``ops/library.py``), which
``torch.export`` keeps whole.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build, library
from sgaligner_tpu_torch.ops.pct_embed import acc_dtype


def _z(xs, w):
    """z = concat(xs) @ w rounded to the compute dtype, [O, P, K]."""
    acc = acc_dtype(xs[0].dtype)
    return torch.matmul(torch.cat(xs, dim=-1).to(acc), w.to(acc)).to(xs[0].dtype)


def pct_tail_plain(x1, x2, x3, x4, w, mask, with_index=False):
    acc = acc_dtype(x1.dtype)
    z = _z([x1, x2, x3, x4], w).to(acc)                          # [O, P, K]
    m = mask.to(acc)
    out = (z.amax(dim=1), z.amin(dim=1),
           (z.sum(1) * m).sum(0, keepdim=True),
           ((z * z).sum(1) * m).sum(0, keepdim=True))
    if not with_index:
        return out
    # torch.argmax / argmin return the first index, as jnp.argmax does
    return (*out, z.argmax(dim=1).to(torch.int32), z.argmin(dim=1).to(torch.int32))


def pct_tail(x1, x2, x3, x4, w, mask, with_index=False):
    """x_i: [O, P, 128] SA-block outputs; w: [512, K] (K a multiple of 128);
    mask: [O, 1] (1 = valid object); all in the compute dtype. Returns
    ``(pmax [O, K], pmin [O, K], ssum [1, K], ssumsq [1, K])`` at f32 (f64
    for f64 inputs) and, with ``with_index``, ``amax, amin [O, K]`` int32;
    through the ops ``sgaligner::pct_tail`` and ``pct_tail_indexed``."""
    if with_index:
        return _tail_indexed_op(x1, x2, x3, x4, w, mask)
    return _tail_op(x1, x2, x3, x4, w, mask)


def _tail_cuda(x1, x2, x3, x4, w, mask, with_index=False):
    name = "pct_tail"
    o, p, k = _check(name, (x1, x2, x3, x4), w, mask)
    dev = x1.device
    pmax = torch.empty((o, k), dtype=torch.float32, device=dev)
    pmin = torch.empty_like(pmax)
    s1 = torch.zeros((1, k), dtype=torch.float32, device=dev)
    s2 = torch.zeros_like(s1)
    idx = ((torch.empty((o, k), dtype=torch.int32, device=dev),
            torch.empty((o, k), dtype=torch.int32, device=dev))
           if with_index else (None, None))
    if o:
        groups, work = _tail_work(dev, o, k, x1.dtype)
        _build.launch(name, "sga_pct_tail", dev,
                      x1.data_ptr(), x2.data_ptr(), x3.data_ptr(),
                      x4.data_ptr(), w.data_ptr(), mask.data_ptr(),
                      pmax.data_ptr(), pmin.data_ptr(), s1.data_ptr(),
                      s2.data_ptr(), *(t.data_ptr() if t is not None else None
                                       for t in idx),
                      work.data_ptr(), groups, o, p, k,
                      _build.DTYPE_CODE[x1.dtype])
    return (pmax, pmin, s1, s2, *idx) if with_index else (pmax, pmin, s1, s2)


def _tail_fake(x1, x2, x3, x4, w, mask, with_index=False):
    o, k = x1.shape[0], w.shape[-1]
    acc = acc_dtype(x1.dtype)
    out = (x1.new_empty((o, k), dtype=acc), x1.new_empty((o, k), dtype=acc),
           x1.new_empty((1, k), dtype=acc), x1.new_empty((1, k), dtype=acc))
    if not with_index:
        return out
    return (*out, x1.new_empty((o, k), dtype=torch.int32),
            x1.new_empty((o, k), dtype=torch.int32))


_TAIL_ARGS = "(Tensor x1, Tensor x2, Tensor x3, Tensor x4, Tensor w, Tensor mask)"
_tail_op = library.define(
    "pct_tail", _TAIL_ARGS + " -> (Tensor, Tensor, Tensor, Tensor)",
    pct_tail_plain, _tail_cuda, _tail_fake)
_tail_indexed_op = library.define(
    "pct_tail_indexed",
    _TAIL_ARGS + " -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    *(library.flagged(f) for f in (pct_tail_plain, _tail_cuda, _tail_fake)))


def _tail_work(device, o: int, k: int, dtype):
    """Blocks per 128-column slice and the forward's work buffer
    (``sga_pct_tail`` in csrc/pct_tail.cu). bf16: one block of two
    objects-walking warpgroups per multiprocessor, a slice of sums per
    warpgroup, after the transposed W; f32: two blocks per multiprocessor,
    a slice each."""
    slices = k // 128
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sums = _build.slice_stride(2 * k)
    if dtype == torch.bfloat16:
        groups = max(1, min(sms // slices, (o + 1) // 2))
        n = 512 * k // 2 + 2 * groups * sums
    else:
        groups = max(1, min(2 * sms // slices, o))
        n = groups * sums
    return groups, torch.empty(n, dtype=torch.float32, device=device)


def _check(name, xs, w, mask):
    _build.check_cuda(name, {"x1": xs[0], "x2": xs[1], "x3": xs[2],
                             "x4": xs[3], "w": w, "mask": mask}, xs[0].dtype)
    o, p, _ = xs[0].shape
    k = w.shape[-1]
    for i, t in enumerate(xs):
        _build.check_shape(name, f"x{i + 1}", t, (o, p, 128))
    if k % 128:
        raise ValueError(f"{name}: K = {k} is not a multiple of 128")
    _build.check_shape(name, "w", w, (512, k))
    _build.check_shape(name, "mask", mask, (o, 1))
    return o, p, k


def pct_tail_bwd_plain(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum, dsumsq,
                       amax, amin):
    acc, dt = acc_dtype(x1.dtype), x1.dtype
    xs = [x1, x2, x3, x4]
    z = _z(xs, w)
    p, c = x1.shape[1], x1.shape[2]
    pt = torch.arange(p, device=x1.device)[None, :, None]
    zero = torch.zeros((), dtype=acc, device=x1.device)
    g = torch.where(pt == amax.long()[:, None, :], dpmax.to(acc)[:, None, :], zero)
    g = g + torch.where(pt == amin.long()[:, None, :], dpmin.to(acc)[:, None, :], zero)
    m = mask.to(acc)
    a1, a2 = m * dsum.to(acc), m * dsumsq.to(acc)                  # [O, K]
    g2 = (g + (a1[:, None] + 2.0 * z.to(acc) * a2[:, None])).to(dt).to(acc)
    dxs = [torch.matmul(g2, w[i * c:(i + 1) * c].to(acc).t()).to(dt)
           for i in range(4)]
    dw = torch.einsum("opc,opk->ck", torch.cat(xs, dim=-1).to(acc), g2)
    return (*dxs, dw)


def pct_tail_bwd(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum, dsumsq, amax,
                 amin):
    """Gradients of ``pct_tail`` for the cotangents ``dpmax, dpmin [O, K]``
    and ``dsum, dsumsq [1, K]`` (f32; f64 for f64 inputs), routed to the
    forward's ``amax, amin``: ``(dx1, dx2, dx3, dx4)`` in the compute dtype
    and ``dw [512, K]`` at the accumulation dtype."""
    if x1.device.type == "cpu":
        return pct_tail_bwd_plain(x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum,
                                  dsumsq, amax, amin)
    name = "pct_tail_bwd"
    o, p, k = _check(name, (x1, x2, x3, x4), w, mask)
    _build.check_cuda(name, {"dpmax": dpmax, "dpmin": dpmin, "dsum": dsum,
                             "dsumsq": dsumsq}, torch.float32)
    _build.check_cuda(name, {"x1": x1, "amax": amax, "amin": amin})
    for key, t, shape in (("dpmax", dpmax, (o, k)), ("dpmin", dpmin, (o, k)),
                          ("dsum", dsum, (1, k)), ("dsumsq", dsumsq, (1, k)),
                          ("amax", amax, (o, k)), ("amin", amin, (o, k))):
        _build.check_shape(name, key, t, shape)
    if amax.dtype != torch.int32 or amin.dtype != torch.int32:
        raise ValueError(f"{name}: amax / amin must be torch.int32")
    dev = x1.device
    dxs = [torch.empty_like(x1) for _ in range(4)]
    dw = torch.zeros((512, k), dtype=torch.float32, device=dev)
    if o:
        bf16 = x1.dtype == torch.bfloat16
        g = torch.empty((o * p, k), dtype=x1.dtype, device=dev)
        # bf16: W transposed for the g pass; the weight gradient's rows
        # split over 32 blocks per 256 columns of K
        wt = torch.empty((k, 512), dtype=x1.dtype, device=dev) if bf16 else None
        splits = 32 if bf16 else 8
        part = torch.empty((splits, 512 * k), dtype=torch.float32, device=dev)
        _build.launch(name, "sga_pct_tail_bwd", dev,
                      *(t.data_ptr() if t is not None else None
                        for t in (x1, x2, x3, x4, w, mask, dpmax, dpmin, dsum,
                                  dsumsq, amax, amin, g, wt, *dxs, part)),
                      splits, dw.data_ptr(), o, p, k, _build.DTYPE_CODE[x1.dtype])
    return (*dxs, dw)


def pct_tail_pool(x1, x2, x3, x4, w, mask):
    """``(pmax, pmin, ssum, ssumsq)`` of ``pct_tail`` with gradients where an
    input asks for them: then ``PctTail`` (the indexed forward and the
    backward kernel, as the JAX op's custom VJP in either mode), otherwise
    the serving form without indices."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1, x2, x3, x4, w)):
        return PctTail.apply(x1, x2, x3, x4, w, mask)
    return pct_tail(x1, x2, x3, x4, w, mask)


class PctTail(torch.autograd.Function):
    """``pct_tail`` with the index outputs saved for ``pct_tail_bwd``;
    returns ``(pmax, pmin, ssum, ssumsq)``."""

    @staticmethod
    def forward(ctx, x1, x2, x3, x4, w, mask):
        pmax, pmin, s1, s2, amax, amin = pct_tail(x1, x2, x3, x4, w, mask,
                                                  with_index=True)
        ctx.save_for_backward(x1, x2, x3, x4, w, mask, amax, amin)
        return pmax, pmin, s1, s2

    @staticmethod
    def backward(ctx, dpmax, dpmin, dsum, dsumsq):
        x1, x2, x3, x4, w, mask, amax, amin = ctx.saved_tensors
        *dxs, dw = pct_tail_bwd(x1, x2, x3, x4, w, mask, dpmax.contiguous(),
                                dpmin.contiguous(), dsum.contiguous(),
                                dsumsq.contiguous(), amax, amin)
        return (*dxs, dw.to(w.dtype), None)
