"""PCT point embedding: the two conv(no bias) layers of NaivePCT, forward
and backward.

Counterpart of ``sgaligner_tpu/ops/pct_embed.py`` (``embed_first_fused``,
``embed_second_fused`` and their custom VJPs):

* ``embed_first(x_cf, w, mask)``: channel-first points ``[O, 3, P]`` times
  ``w [3, C]`` -> the pre-BN activation ``h0 [O, P, C]`` (rounded to the
  compute dtype) + masked per-channel sums ``Σh, Σh² [1, C]``.
* ``embed_second(h0, wf, bf, w, mask)``: prologue ``relu(h0·wf + bf)`` (layer
  0's folded BN, at f32 then rounded), times ``w [C, C2]`` -> ``h1`` + sums.
* ``embed_first_bwd`` / ``embed_second_bwd``: their backward for the
  cotangents of ``(h, ssum, ssumsq)`` (the Pallas kernels ``_e1_bwd_kernel``
  and ``_e2_bwd_kernel``); the points get no gradient (they are data).
* ``EmbedFirst`` / ``EmbedSecond``: the ``torch.autograd.Function``s of the
  pairs, which NaivePCT runs in both modes (the JAX ops carry one custom
  VJP for both); with gradients off they save nothing.

A CUDA tensor goes through the kernels of ``csrc/pct_embed.cu`` (the bf16
``embed_second`` through ``csrc/pct_embed_sm90.cu``, its backward through
``csrc/pct_embed_bwd_sm90.cu``; the f32 pair on ``csrc/tail_f32.cuh``'s
mainloop, its jobs in ``csrc/embed_f32.cuh``; ``embed_first_bwd`` at both
dtypes through the streaming reduction of ``csrc/pct_embed_first_bwd.cu``);
a CPU tensor through the plain versions below, which repeat the kernels'
arithmetic (f64 accumulation for f64 inputs, f32 otherwise). The two
forwards are the custom ops ``sgaligner::embed_first`` and
``sgaligner::embed_second`` (``ops/library.py``), which ``torch.export``
keeps whole.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build, library


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for bf16/f32 compute, f64 under f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def masked_sums(h: torch.Tensor, mask: torch.Tensor):
    """Σ and Σ² of [O, P, C] over points, then mask-weighted over objects
    (mask [O, 1]); both [1, C] in the accumulation dtype."""
    acc = acc_dtype(h.dtype)
    hf = h.to(acc)
    m = mask.to(acc)
    return ((hf.sum(1) * m).sum(0, keepdim=True),
            ((hf * hf).sum(1) * m).sum(0, keepdim=True))


def embed_first_plain(x_cf, w, mask):
    acc = acc_dtype(x_cf.dtype)
    h = torch.einsum("ocp,cd->opd", x_cf.to(acc), w.to(acc)).to(x_cf.dtype)
    return (h, *masked_sums(h, mask))


def embed_second_plain(h0, wf, bf, w, mask):
    acc = acc_dtype(h0.dtype)
    x0 = torch.relu(h0.to(acc) * wf.to(acc) + bf.to(acc)).to(h0.dtype)
    h = torch.matmul(x0.to(acc), w.to(acc)).to(h0.dtype)
    return (h, *masked_sums(h, mask))


def embed_first(x_cf, w, mask):
    """x_cf: [O, 3, P]; w: [3, 128]; mask: [O, 1] (1 = valid object), all in
    the compute dtype. Returns (h0 [O, P, 128], ssum [1, 128], ssumsq)
    through the op ``sgaligner::embed_first``."""
    h, sums = _embed_first_op(x_cf, w, mask)
    return h, sums[:1], sums[1:]


def _embed_first_cpu(x_cf, w, mask):
    h, s1, s2 = embed_first_plain(x_cf, w, mask)
    return h, torch.cat([s1, s2])


def _embed_first_cuda(x_cf, w, mask):
    name = "embed_first"
    _build.check_cuda(name, {"x_cf": x_cf, "w": w, "mask": mask}, x_cf.dtype)
    o, three, p = x_cf.shape
    _build.check_shape(name, "x_cf", x_cf, (o, 3, p))
    _build.check_shape(name, "w", w, (three, 128))
    _build.check_shape(name, "mask", mask, (o, 1))
    h = torch.empty((o, p, 128), dtype=x_cf.dtype, device=x_cf.device)
    sums = _launch_with_sums(name, "sga_embed_first", x_cf.device, o,
                             _build.grid_blocks(x_cf.device, o, per_sm=4),
                             x_cf, w, mask, h, p=p, dtype=x_cf.dtype)
    return h, sums


def _embed_first_fake(x_cf, w, mask):
    o, _, p = x_cf.shape
    return (x_cf.new_empty((o, p, 128)),
            x_cf.new_empty((2, 128), dtype=acc_dtype(x_cf.dtype)))


_embed_first_op = library.define(
    "embed_first", "(Tensor x_cf, Tensor w, Tensor mask) -> (Tensor, Tensor)",
    _embed_first_cpu, _embed_first_cuda, _embed_first_fake)


def _launch_with_sums(name, fn_name, dev, o, slices, *tensors, p, dtype):
    """Launch one embedding forward with ``slices`` scratch slices of
    partial sums (one per block, or per consumer warpgroup of the bf16
    embed_second); returns its masked sums [2, 128] (f32), which
    reduce_slices adds in slice order: the same bits from run to run."""
    sums = torch.zeros((2, 128), dtype=torch.float32, device=dev)
    if o:
        part = _build.scratch(dev, slices, 2 * 128)
        _build.launch(name, fn_name, dev, *(t.data_ptr() for t in tensors),
                      part.data_ptr(), slices, sums.data_ptr(), o, p,
                      _build.DTYPE_CODE[dtype])
    return sums


def embed_second(h0, wf, bf, w, mask):
    """h0: [O, P, 128]; wf/bf: [1, 128] folded BN affine; w: [128, 128];
    mask: [O, 1]; all in the compute dtype. Returns (h1, ssum, ssumsq)
    through the op ``sgaligner::embed_second``."""
    h1, sums = _embed_second_op(h0, wf, bf, w, mask)
    return h1, sums[:1], sums[1:]


def _embed_second_cpu(h0, wf, bf, w, mask):
    h1, s1, s2 = embed_second_plain(h0, wf, bf, w, mask)
    return h1, torch.cat([s1, s2])


def _embed_second_cuda(h0, wf, bf, w, mask):
    name = "embed_second"
    _build.check_cuda(name, {"h0": h0, "wf": wf, "bf": bf, "w": w,
                             "mask": mask}, h0.dtype)
    o, p, c = h0.shape
    _build.check_shape(name, "h0", h0, (o, p, 128))
    for key, t in (("wf", wf), ("bf", bf)):
        _build.check_shape(name, key, t, (1, 128))
    _build.check_shape(name, "w", w, (128, 128))
    _build.check_shape(name, "mask", mask, (o, 1))
    h1 = torch.empty_like(h0)
    tiles = (o * p + 63) // 64
    if h0.dtype == torch.bfloat16:   # the wgmma design: persistent, 2 slices a block
        slices = _build.warpgroup_slices(h0.device, tiles)
    else:   # the first version's slices of 64-row tiles: the sums' order
        _build.check_aligned(name, {"h0": h0, "w": w})
        slices = _build.grid_blocks(h0.device, tiles, per_sm=2)
    sums = _launch_with_sums(name, "sga_embed_second", h0.device, o, slices,
                             h0, wf, bf, w, mask, h1, p=p, dtype=h0.dtype)
    return h1, sums


def _embed_second_fake(h0, wf, bf, w, mask):
    return (torch.empty_like(h0),
            h0.new_empty((2, 128), dtype=acc_dtype(h0.dtype)))


_embed_second_op = library.define(
    "embed_second",
    "(Tensor h0, Tensor wf, Tensor bf, Tensor w, Tensor mask) -> (Tensor, Tensor)",
    _embed_second_cpu, _embed_second_cuda, _embed_second_fake)


# --------------------------------- backward ----------------------------------

def _dz(h, mask, dh, ds1, ds2):
    """dh + m·ds1 + 2·h·m·ds2 (the BN sums' cotangents reach every point of a
    valid object), rounded to h's dtype."""
    acc = acc_dtype(h.dtype)
    m = mask.to(acc)                                     # [O, 1]
    a1, a2 = m * ds1.to(acc), m * ds2.to(acc)            # [O, C]
    return (dh.to(acc) + a1[:, None] + 2.0 * h.to(acc) * a2[:, None]).to(h.dtype)


def embed_first_bwd_plain(x_cf, w, mask, dh, ds1, ds2):
    acc = acc_dtype(x_cf.dtype)
    h = embed_first_plain(x_cf, w, mask)[0]
    dz = _dz(h, mask, dh, ds1, ds2)
    return torch.einsum("okp,opd->kd", x_cf.to(acc), dz.to(acc))


def embed_second_bwd_plain(h0, wf, bf, w, mask, dh, ds1, ds2):
    acc, dt = acc_dtype(h0.dtype), h0.dtype
    pre = h0.to(acc) * wf.to(acc) + bf.to(acc)
    x0 = torch.relu(pre).to(dt)
    h = torch.matmul(x0.to(acc), w.to(acc)).to(dt)
    dz = _dz(h, mask, dh, ds1, ds2).to(acc)
    dw = torch.einsum("opc,opd->cd", x0.to(acc), dz)
    dx0 = torch.matmul(dz, w.to(acc).t())
    g0 = torch.where(pre > 0, dx0, torch.zeros((), dtype=acc, device=h0.device))
    dh0 = (g0 * wf.to(acc)).to(dt)
    return (dh0, (g0 * h0.to(acc)).sum(dim=(0, 1))[None],
            g0.sum(dim=(0, 1))[None], dw)


def _check_cotangents(name, o, p, c, dh, ds1, ds2, dtype):
    _build.check_cuda(name, {"dh": dh}, dtype)
    _build.check_cuda(name, {"dh": dh, "ds1": ds1, "ds2": ds2})
    _build.check_shape(name, "dh", dh, (o, p, c))
    for key, t in (("ds1", ds1), ("ds2", ds2)):
        _build.check_shape(name, key, t, (1, c))
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected torch.float32")


def embed_first_bwd(x_cf, w, mask, dh, ds1, ds2):
    """The weight gradient ``dw [3, 128]`` of ``embed_first`` for the
    cotangents ``dh [O, P, 128]`` (compute dtype) and ``ds1, ds2 [1, 128]``
    (f32; f64 for f64 inputs), at the accumulation dtype."""
    if x_cf.device.type == "cpu":
        return embed_first_bwd_plain(x_cf, w, mask, dh, ds1, ds2)
    name = "embed_first_bwd"
    _build.check_cuda(name, {"x_cf": x_cf, "w": w, "mask": mask}, x_cf.dtype)
    o, three, p = x_cf.shape
    _build.check_shape(name, "x_cf", x_cf, (o, 3, p))
    _build.check_shape(name, "w", w, (three, 128))
    _build.check_shape(name, "mask", mask, (o, 1))
    _check_cotangents(name, o, p, 128, dh, ds1, ds2, x_cf.dtype)
    dev = x_cf.device
    dw = torch.zeros((3, 128), dtype=torch.float32, device=dev)
    if o:
        code = _build.DTYPE_CODE[x_cf.dtype]
        blocks = _build.stream_blocks("sga_embed_first_bwd_rows_per_block", o * p, code, dev)
        part = _build.scratch(dev, blocks, 3 * 128)
        _build.launch(name, "sga_embed_first_bwd", dev,
                      x_cf.data_ptr(), w.data_ptr(), mask.data_ptr(),
                      dh.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
                      part.data_ptr(), blocks, dw.data_ptr(), o, p, code)
    return dw


def embed_second_bwd(h0, wf, bf, w, mask, dh, ds1, ds2):
    """``(dh0 [O, P, 128] in h0's dtype, dwf [1, 128], dbf [1, 128],
    dw [128, 128])`` of ``embed_second`` for the cotangents ``dh`` and
    ``ds1, ds2`` (f32), the last three at the accumulation dtype."""
    if h0.device.type == "cpu":
        return embed_second_bwd_plain(h0, wf, bf, w, mask, dh, ds1, ds2)
    name = "embed_second_bwd"
    _build.check_cuda(name, {"h0": h0, "wf": wf, "bf": bf, "w": w,
                             "mask": mask}, h0.dtype)
    o, p, c = h0.shape
    _build.check_shape(name, "h0", h0, (o, p, 128))
    for key, t in (("wf", wf), ("bf", bf)):
        _build.check_shape(name, key, t, (1, 128))
    _build.check_shape(name, "w", w, (128, 128))
    _build.check_shape(name, "mask", mask, (o, 1))
    _check_cotangents(name, o, p, 128, dh, ds1, ds2, h0.dtype)
    dev = h0.device
    dh0 = torch.empty_like(h0)
    grads = torch.zeros(128 * 128 + 2 * 128, dtype=torch.float32, device=dev)
    if o:
        tiles = (o * p + 63) // 64
        work = None
        if h0.dtype == torch.bfloat16:   # the wgmma design: persistent, 2 slices a block
            blocks = _build.warpgroup_slices(dev, tiles)
        else:   # the first version's slices of 64-row tiles: the sums' order
            _build.check_aligned(name, {"h0": h0, "w": w, "dh": dh, "ds1": ds1, "ds2": ds2})
            blocks = _build.grid_blocks(dev, tiles, per_sm=1)
            work = torch.empty(o * p * 128 + 128 * 128, dtype=torch.float32, device=dev)
        part = _build.scratch(dev, blocks, grads.numel())
        _build.launch(name, "sga_embed_second_bwd", dev,
                      h0.data_ptr(), wf.data_ptr(), bf.data_ptr(), w.data_ptr(),
                      mask.data_ptr(), dh.data_ptr(), ds1.data_ptr(),
                      ds2.data_ptr(), dh0.data_ptr(),
                      None if work is None else work.data_ptr(), part.data_ptr(),
                      blocks, grads.data_ptr(), o, p, _build.DTYPE_CODE[h0.dtype])
    dw, dwf, dbf = torch.split(grads, (128 * 128, 128, 128))
    return dh0, dwf.view(1, 128), dbf.view(1, 128), dw.view(128, 128)


class EmbedFirst(torch.autograd.Function):
    """``embed_first`` with its backward kernel. The points get no gradient
    (they are data, ``stop_gradient`` in the JAX model): a zero tensor where
    autograd asks for one."""

    @staticmethod
    def forward(ctx, x_cf, w, mask):
        h, s1, s2 = embed_first(x_cf, w, mask)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x_cf, w, mask)
        return h, s1, s2

    @staticmethod
    def backward(ctx, dh, ds1, ds2):
        x_cf, w, mask = ctx.saved_tensors
        dw = embed_first_bwd(x_cf, w, mask, dh.contiguous(), ds1.contiguous(),
                             ds2.contiguous())
        dx = torch.zeros_like(x_cf) if ctx.needs_input_grad[0] else None
        return dx, dw.to(w.dtype), None


class EmbedSecond(torch.autograd.Function):
    """``embed_second`` with its backward kernel (gradients for h0, the
    folded affine and the weight; none for the mask)."""

    @staticmethod
    def forward(ctx, h0, wf, bf, w, mask):
        h, s1, s2 = embed_second(h0, wf, bf, w, mask)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(h0, wf, bf, w, mask)
        return h, s1, s2

    @staticmethod
    def backward(ctx, dh, ds1, ds2):
        h0, wf, bf, w, mask = ctx.saved_tensors
        dh0, dwf, dbf, dw = embed_second_bwd(h0, wf, bf, w, mask,
                                             dh.contiguous(), ds1.contiguous(),
                                             ds2.contiguous())
        return dh0, dwf.to(wf.dtype), dbf.to(bf.dtype), dw.to(w.dtype), None
