"""PCT self-attention: the SA / OA block's inference form, its training op
with the backward, the block op ``pct_block_fused`` with its own backward,
and the bare attention op ``pct_attention_fused`` with its backward.

Counterpart of ``sgaligner_tpu/ops/pct_attention.py``: ``pct_block_eval``;
``pct_block_residual`` (the training block: ``pct_block_fused``'s forward,
the batch-statistics BN fold ``_fold_from_sums`` and the relu / residual
epilogue, with the two-kernel backward ``_epi_sums_kernel`` then
``_block_res_bwd_kernel``); ``pct_block_fused`` (its forward and
``_block_bwd_kernel``); ``pct_attention_fused`` (``_fwd_kernel`` and
``_bwd_kernel``); and the plain composition they are defined by
(``_qk_scale``, ``_project``, ``_attn_core``, ``_block_math``). Reference
quirks kept:

* q and k share one projection of the same input, so ``E = q qᵀ`` is
  symmetric;
* the softmax normaliser runs over the first energy axis and the attention is
  applied transposed, ``y[j] = Σ_i A[i, j] v[i]`` — the column softmax of E;
* OA (``double_norm=True``) re-normalises the rows by ``1e-9 + Σ``, and its
  residual branch is ``trans(x - attn(x))``;
* SA scales E by ``1/sqrt(da)``, folded into the q/k weight as ``da^-1/4``.

Every op takes both flag sets, SA (``scale=True, double_norm=False``) and OA
(``False, True``); the block ops take ``double_norm`` as the OA residual
too, as the JAX ops do; ``pct_block_eval`` also the mixed pairs, and
``BlockEval`` makes it differentiable. A CUDA tensor goes through
``csrc/pct_attention.cu`` (in bf16, ``pct_block_eval``, ``block_fwd`` and
``attn_fwd`` through ``csrc/pct_block_eval_sm90.cu`` and the three backwards
through ``csrc/pct_block_bwd_sm90.cu``; ``epi_sums`` at both dtypes through
the streaming reduction of ``csrc/pct_epi_sums.cu``); a CPU tensor through the
plain versions (``block_eval_plain``, ``block_fwd_plain``,
``epi_sums_plain``, ``block_res_bwd_plain``, ``block_bwd_plain``,
``attn_fwd_plain``, ``attn_bwd_plain``), which repeat
the JAX kernels op for op (their exponentials run in the compute dtype
against a column max, as the TPU kernels' do; the CUDA kernels use an f32
log-sum-exp instead). ``pct_block_eval`` is the custom op
``sgaligner::pct_block_eval`` (``ops/library.py``), which ``torch.export``
keeps whole.

Widths: every kernel takes C = 128, da = 32 (NaivePCT, SPCT) and C = 256,
da = 64 (FullPCT's OA blocks, and the two ops at that width), at both dtypes;
at C = 256 through ``csrc/pct_attention_c256.cu`` (and ``epi_sums`` through
``csrc/pct_epi_sums.cu``), each counted under its name with ``_c256``. A CUDA
tensor of any other width raises. The plain versions take any width.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build, library
from sgaligner_tpu_torch.ops.pct_embed import acc_dtype, masked_sums
from sgaligner_tpu_torch.parallel.mesh import reduce_sum

# the kernels' widths C (da = C / 4): the suffix of the C entry points and
# of the launch counts at each
WIDTHS = {128: "", 256: "_c256"}


def kernel_width(name: str, x) -> tuple[int, str]:
    """(C, its suffix) of x [O, P, C] for the kernel ``name``; raises for a
    width it has no kernel for."""
    c = x.shape[-1]
    if x.dim() != 3 or c not in WIDTHS:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes "
                         f"[O, P, C] with C in {sorted(WIDTHS)}")
    return c, WIDTHS[c]


def qk_scale(wqk, scale: bool):
    """SA's 1/sqrt(da) energy scale folded into the shared q/k weight
    (``wqk · da^-1/4``, in the weight's dtype)."""
    if not scale:
        return wqk
    da = wqk.shape[-1]
    return wqk * torch.tensor(float(da) ** -0.25, dtype=wqk.dtype)


def project(x, wqk, wv, bv, scale: bool):
    """x [O, P, C] -> q [O, P, da], v [O, P, C], each rounded to x's dtype."""
    acc = acc_dtype(x.dtype)
    xa = x.to(acc)
    q = torch.matmul(xa, qk_scale(wqk, scale).to(acc)).to(x.dtype)
    v = (torch.matmul(xa, wv.to(acc)) + bv.to(acc)).to(x.dtype)
    return q, v


def attn_core(q, v, double_norm: bool):
    """Column softmax of E = q qᵀ applied to v (f32 accumulation)."""
    acc = acc_dtype(q.dtype)
    qa = q.to(acc)
    e = torch.matmul(qa, qa.transpose(1, 2))                      # [O, P, P]
    m = e.amax(dim=1, keepdim=True)                               # [O, 1, P]
    g = torch.exp((e - m).to(v.dtype))
    z = g.to(acc).sum(dim=1, keepdim=True)
    gt = g * (1.0 / z).to(v.dtype)
    if double_norm:
        s = 1e-9 + gt.to(acc).sum(dim=2, keepdim=True)
        gt = gt * (1.0 / s).to(v.dtype)
    return torch.matmul(gt.to(acc), v.to(acc))                    # [O, P, C]


def block_math(x, wqk, wv, bv, wt, bt, scale: bool, double_norm: bool):
    """t_out = trans(u) with u = attn(x) (SA) or x - attn(x) (OA)."""
    acc = acc_dtype(x.dtype)
    q, v = project(x, wqk, wv, bv, scale)
    y = attn_core(q, v, double_norm).to(x.dtype)
    u = (x - y) if double_norm else y
    return (torch.matmul(u.to(acc), wt.to(acc)) + bt.to(acc)).to(x.dtype)


def block_eval_plain(x, wqk, wv, bv, wt, bt, wbn, bbn, scale=True,
                     double_norm=False):
    acc = acc_dtype(x.dtype)
    t_out = block_math(x, wqk, wv, bv, wt, bt, scale, double_norm)
    z = t_out.to(acc) * wbn.to(acc) + bbn.to(acc)
    return (x.to(acc) + torch.relu(z)).to(x.dtype)


def pct_block_eval(x, wqk, wv, bv, wt, bt, wbn, bbn, scale=True,
                   double_norm=False):
    """Inference SA/OA block ``x + relu(t_out·wbn + bbn)``, through the op
    ``sgaligner::pct_block_eval``.

    x: [O, P, C] (C = 128 or 256, da = C / 4); wqk [C, da] (unscaled); wv,
    wt [C, C]; bv, bt [C] in x's dtype; wbn, bbn [C]: the BN affine folded
    from running statistics (at >= f32). ``scale=True, double_norm=False``
    is SA, ``scale=False, double_norm=True`` OA; the mixed pairs run too (the
    scale is folded into Wqk before the launch). No gradient: ``BlockEval``
    is the differentiable form."""
    return _block_eval_op(x, wqk, wv, bv, wt, bt, wbn, bbn, bool(scale),
                          bool(double_norm))


def _block_eval_cuda(x, wqk, wv, bv, wt, bt, wbn, bbn, scale, double_norm):
    c, suffix = kernel_width("pct_block_eval", x)
    name = "pct_block_eval" + suffix
    dt = x.dtype
    wqk_s = qk_scale(wqk, scale).contiguous()
    wbn32 = wbn.to(torch.float32).reshape(-1).contiguous()
    bbn32 = bbn.to(torch.float32).reshape(-1).contiguous()
    _build.check_cuda(name, {"x": x, "wqk": wqk_s, "wv": wv, "bv": bv,
                             "wt": wt, "bt": bt}, dt)
    _build.check_cuda(name, {"x": x, "wbn": wbn32, "bbn": bbn32})
    o, p, _ = x.shape
    _build.check_shape(name, "wqk", wqk_s, (c, c // 4))
    for key, t in (("wv", wv), ("wt", wt)):
        _build.check_shape(name, key, t, (c, c))
    for key, t in (("bv", bv), ("bt", bt), ("wbn", wbn32), ("bbn", bbn32)):
        _build.check_shape(name, key, t, (c,))
    out = torch.empty_like(x)
    q, v, lse = _block_work(x)
    if o:
        _build.launch(name, "sga_pct_block_eval" + suffix, x.device,
                      x.data_ptr(), wqk_s.data_ptr(), wv.data_ptr(),
                      bv.data_ptr(), wt.data_ptr(), bt.data_ptr(),
                      wbn32.data_ptr(), bbn32.data_ptr(), q.data_ptr(),
                      v.data_ptr(), lse.data_ptr(), out.data_ptr(), o, p,
                      int(double_norm), _build.DTYPE_CODE[dt])
    return out


def _block_eval_fake(x, wqk, wv, bv, wt, bt, wbn, bbn, scale, double_norm):
    return torch.empty_like(x)


_block_eval_op = library.define(
    "pct_block_eval",
    "(Tensor x, Tensor wqk, Tensor wv, Tensor bv, Tensor wt, Tensor bt, "
    "Tensor wbn, Tensor bbn, bool scale, bool double_norm) -> Tensor",
    block_eval_plain, _block_eval_cuda, _block_eval_fake)


def _block_work(x):
    """The work buffers q [O, P, da], v, lse of the block kernels and the
    attention forward. bf16 at C = 128 (the wgmma design): vᵀ [O, 128, pp]
    and lse [O, pp], the key axis padded to a multiple of 8 (16-byte rows for
    TMA); otherwise v [O, P, C], lse [O, P]."""
    o, p, c = x.shape
    q = torch.empty((o, p, c // 4), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16 and c == 128:
        pp = (p + 7) // 8 * 8
        return (q, torch.empty((o, 128, pp), dtype=x.dtype, device=x.device),
                torch.empty((o, pp), dtype=torch.float32, device=x.device))
    return (q, torch.empty_like(x),
            torch.empty((o, p), dtype=torch.float32, device=x.device))


class BlockEval(torch.autograd.Function):
    """``pct_block_eval`` with gradients, the counterpart of its JAX custom
    VJP: the forward is the kernel, the backward differentiates the plain
    version ``block_eval_plain`` (frozen-BN fine-tuning, a cold path). With
    gradients off nothing is saved."""

    @staticmethod
    def forward(ctx, x, wqk, wv, bv, wt, bt, wbn, bbn, scale=True,
                double_norm=False):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, wqk, wv, bv, wt, bt, wbn, bbn)
        ctx.flags = (scale, double_norm)
        return pct_block_eval(x, wqk, wv, bv, wt, bt, wbn, bbn, scale,
                              double_norm)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = block_eval_plain(*inputs, *ctx.flags)
        return (*torch.autograd.grad(out, inputs, dy), None, None)


# ------------------------------- training ------------------------------------

def _check_attn(name, x, wqk, wv, bv):
    """Checks the attention's inputs at x's width C; returns (O, P, C)."""
    _build.check_cuda(name, {"x": x, "wqk": wqk, "wv": wv, "bv": bv}, x.dtype)
    o, p, c = x.shape
    _build.check_shape(name, "wqk", wqk, (c, c // 4))
    _build.check_shape(name, "wv", wv, (c, c))
    _build.check_shape(name, "bv", bv, (c,))
    return o, p, c


def _check_block(name, x, wqk, wv, bv, wt, bt, mask):
    o, p, c = _check_attn(name, x, wqk, wv, bv)
    _build.check_cuda(name, {"x": x, "wt": wt, "bt": bt, "mask": mask}, x.dtype)
    _build.check_shape(name, "wt", wt, (c, c))
    _build.check_shape(name, "bt", bt, (c,))
    _build.check_shape(name, "mask", mask, (o, 1))
    return o, p, c


def block_fwd_plain(x, wqk, wv, bv, wt, bt, mask, scale=True, double_norm=False):
    t_out = block_math(x, wqk, wv, bv, wt, bt, scale, double_norm)
    return (t_out, *masked_sums(t_out, mask))


def block_fwd(x, wqk, wv, bv, wt, bt, mask, scale=True, double_norm=False):
    """Training forward of the SA/OA block: ``(t_out [O, P, C] in x's
    dtype, ssum [1, C], ssumsq [1, C])``, the sums masked by
    ``mask [O, 1]`` at f32 (f64 for f64 inputs). Weights as in
    ``pct_block_eval``, in x's dtype."""
    if x.device.type == "cpu":
        return block_fwd_plain(x, wqk, wv, bv, wt, bt, mask, scale, double_norm)
    _, suffix = kernel_width("pct_block_fwd", x)
    name = "pct_block_fwd" + suffix
    wqk_s = qk_scale(wqk, scale).contiguous()
    o, p, c = _check_block(name, x, wqk_s, wv, bv, wt, bt, mask)
    dev, dt = x.device, x.dtype
    t_out = torch.empty_like(x)
    sums = torch.zeros((2, c), dtype=torch.float32, device=dev)
    if o:
        q, v, lse = _block_work(x)
        if dt == torch.bfloat16 and c == 128:
            # one sum slice per consumer warpgroup of the persistent apply
            # pass (two a block, one block per SM, one per pair of row tiles)
            blocks = _build.warpgroup_slices(dev, o * (((p + 63) // 64 + 1) // 2))
        else:
            blocks = _build.grid_blocks(dev, o * ((p + 63) // 64), per_sm=1)
        part = _build.scratch(dev, blocks, 2 * c)
        _build.launch(name, "sga_pct_block_fwd" + suffix, dev,
                      *(t.data_ptr() for t in (x, wqk_s, wv, bv, wt, bt, mask,
                                               q, v, lse, t_out, part)),
                      blocks, sums.data_ptr(), o, p, int(double_norm),
                      _build.DTYPE_CODE[dt])
    return t_out, sums[:1], sums[1:]


def fold_from_sums(bn_scale, bn_bias, ssum, ssumsq, count, eps):
    """MaskedBatchNorm's batch-statistics fold from the masked sums:
    ``w = scale / sqrt(var + eps)``, ``b = bias - mean·w`` at >= f32."""
    sdt = acc_dtype(bn_scale.dtype)
    mean = ssum[0].to(sdt) / count
    var = torch.clamp_min(ssumsq[0].to(sdt) / count - mean * mean, 0.0)
    w = bn_scale.to(sdt) / torch.sqrt(var + eps)
    return w, bn_bias.to(sdt) - mean * w


def epilogue(x, t_out, w, b):
    """``x + relu(t_out·w + b)`` in x's dtype (the fold rounded to it)."""
    return x + torch.relu(t_out * w.to(t_out.dtype) + b.to(t_out.dtype))


def _live(t_out, wbn, bbn):
    """The epilogue's relu routing: multiply-add in the compute dtype,
    compared at the accumulation dtype."""
    dt = t_out.dtype
    return (t_out * wbn.to(dt) + bbn.to(dt)).to(acc_dtype(dt)) > 0


def epi_sums_plain(t_out, wbn, bbn, dy):
    acc = acc_dtype(t_out.dtype)
    zero = torch.zeros((), dtype=acc, device=t_out.device)
    g = torch.where(_live(t_out, wbn, bbn), dy.to(acc), zero)
    return ((g * t_out.to(acc)).sum(dim=(0, 1))[None], g.sum(dim=(0, 1))[None])


def epi_sums(t_out, wbn, bbn, dy):
    """The fold's gradient sums of the training epilogue for its cotangent
    ``dy``: ``(Σ g·t_out, Σ g)`` [1, C] each, ``g = dy`` where
    ``t_out·wbn + bbn > 0``; f32 (f64 for f64 inputs). wbn, bbn [C] at
    f32."""
    if t_out.device.type == "cpu":
        return epi_sums_plain(t_out, wbn, bbn, dy)
    c, suffix = kernel_width("pct_epi_sums", t_out)
    name = "pct_epi_sums" + suffix
    wbn32, bbn32 = (v if v.dtype == torch.float32 and v.dim() == 1 and v.is_contiguous()
                    else v.to(torch.float32).reshape(-1).contiguous() for v in (wbn, bbn))
    _build.check_cuda(name, {"t_out": t_out, "dy": dy}, t_out.dtype)
    _build.check_cuda(name, {"t_out": t_out, "wbn": wbn32, "bbn": bbn32})
    o, p, _ = t_out.shape
    _build.check_shape(name, "dy", dy, (o, p, c))
    for key, t in (("wbn", wbn32), ("bbn", bbn32)):
        _build.check_shape(name, key, t, (c,))
    dev = t_out.device
    # the kernel's slice sum writes every entry
    sums = (torch.empty if o else torch.zeros)((2, c), dtype=torch.float32, device=dev)
    if o:
        code = _build.DTYPE_CODE[t_out.dtype]
        blocks = _build.stream_blocks(f"sga_pct_epi_sums{suffix}_rows_per_block", o * p, code,
                                      dev)
        part = _build.scratch(dev, blocks, 2 * c)
        _build.launch(name, "sga_pct_epi_sums" + suffix, dev,
                      t_out.data_ptr(), wbn32.data_ptr(), bbn32.data_ptr(),
                      dy.data_ptr(), part.data_ptr(), blocks, sums.data_ptr(),
                      o * p, code)
    return sums[:1], sums[1:]


def _recompute(x, wqk, wv, bv, scale, double_norm):
    """The forward again for a backward: the core's output at the
    accumulation dtype with its graph over fresh leaves (qg, vg)."""
    q, v = project(x, wqk, wv, bv, scale)
    with torch.enable_grad():
        qg, vg = q.detach().requires_grad_(True), v.detach().requires_grad_(True)
        return qg, vg, attn_core(qg, vg, double_norm)


def _through_core(x, wqk, wv, scale, qg, vg, y_acc, dy):
    """The attention core's and the projections' backward for the core
    output's cotangent dy (accumulation dtype): (dx, dwqk, dwv, dbv [1, C]),
    dx before any residual, all at the accumulation dtype."""
    acc = acc_dtype(x.dtype)
    dq, dv = torch.autograd.grad(y_acc, (qg, vg), dy)
    dq, dv = dq.to(acc), dv.to(acc)
    s = float(wqk.shape[-1]) ** -0.25 if scale else 1.0
    dwqk = s * torch.einsum("opc,opd->cd", x.to(acc), dq)
    dwv = torch.einsum("opc,opd->cd", x.to(acc), dv)
    dx = (torch.matmul(dq, qk_scale(wqk, scale).to(acc).t())
          + torch.matmul(dv, wv.to(acc).t()))
    return dx, dwqk, dwv, dv.sum(dim=(0, 1))[None]


def _block_bwd_math(x, wqk, wv, bv, wt, bt, mask, dsum, dsumsq, scale,
                    double_norm, dt_of):
    """The block backward both block ops share: with ``dt_of(t_out)`` the
    cotangent reaching t_out (accumulation dtype), dz = dt + m·dsum +
    2·t_out·m·dsumsq rounded, then trans and the core. Returns (dx at the
    accumulation dtype, +du for OA, no residual; dwqk, dwv, dbv, dwt, dbt)."""
    acc, dt = acc_dtype(x.dtype), x.dtype
    qg, vg, y_acc = _recompute(x, wqk, wv, bv, scale, double_norm)
    y = y_acc.detach().to(dt)
    u = (x - y) if double_norm else y
    t_out = (torch.matmul(u.to(acc), wt.to(acc)) + bt.to(acc)).to(dt)
    m = mask.to(acc)
    a1, a2 = m * dsum.to(acc), m * dsumsq.to(acc)                   # [O, C]
    dz = (dt_of(t_out) + a1[:, None]
          + 2.0 * t_out.to(acc) * a2[:, None]).to(dt).to(acc)
    dwt = torch.einsum("opc,opd->cd", u.to(acc), dz)
    dbt = dz.sum(dim=(0, 1))[None]
    du = torch.matmul(dz, wt.to(acc).t())
    dx, dwqk, dwv, dbv = _through_core(x, wqk, wv, scale, qg, vg, y_acc,
                                       -du if double_norm else du)
    if double_norm:  # u = x - y: dx gets +du directly
        dx = dx + du
    return dx, dwqk, dwv, dbv, dwt, dbt


def block_res_bwd_plain(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum,
                        dsumsq, scale=True, double_norm=False):
    acc = acc_dtype(x.dtype)
    zero = torch.zeros((), dtype=acc, device=x.device)

    def dt_of(t_out):  # epilogue backward: dt = dxn·1{t_out·w + b > 0}·w
        return torch.where(_live(t_out, wbn, bbn), dxn.to(acc), zero) * wbn.to(acc)

    dx, *grads = _block_bwd_math(x, wqk, wv, bv, wt, bt, mask, dsum, dsumsq,
                                 scale, double_norm, dt_of)
    return ((dx + dxn.to(acc)).to(x.dtype), *grads)


def block_bwd_plain(x, wqk, wv, bv, wt, bt, mask, dt, dsum, dsumsq, scale=True,
                    double_norm=False):
    acc = acc_dtype(x.dtype)
    dx, *grads = _block_bwd_math(x, wqk, wv, bv, wt, bt, mask, dsum, dsumsq,
                                 scale, double_norm, lambda t_out: dt.to(acc))
    return (dx.to(x.dtype), *grads)


def _bwd_work(x):
    """The block and attention backwards' device buffers, one byte buffer
    the C entry carves (``sga_pct_bwd_work_bytes``, at C = 256
    ``sga_pct_bwd_work_bytes_c256``)."""
    o, p, c = x.shape
    query = getattr(_build.lib(), "sga_pct_bwd_work_bytes" + WIDTHS[c])
    return torch.empty(query(o, p, _build.DTYPE_CODE[x.dtype]), dtype=torch.uint8,
                       device=x.device)


def n_grad(c: int) -> int:
    """Floats of a block backward's weight gradients at width C: dWqk, dWv,
    dbv, dWt, dbt (f32)."""
    return c * (c // 4) + 2 * c * c + 2 * c


def _block_backward(name, fn_name, x, wqk, wv, bv, wt, bt, mask, cot, vecs,
                    scale, double_norm):
    """Launch one block backward: ``cot`` is dxn (pct_block_res_bwd) or dt
    (pct_block_bwd), ``vecs`` its [C] f32 inputs in the C entry's order;
    ``name`` and ``fn_name`` take the suffix of x's width."""
    _, suffix = kernel_width(name, x)
    name, fn_name = name + suffix, fn_name + suffix
    wqk_s = qk_scale(wqk, scale).contiguous()
    o, p, c = _check_block(name, x, wqk_s, wv, bv, wt, bt, mask)
    da = c // 4
    dev, dt = x.device, x.dtype
    vecs = {k: t.to(torch.float32).reshape(-1).contiguous() for k, t in vecs}
    _build.check_cuda(name, {"cotangent": cot}, dt)
    _build.check_cuda(name, {"x": x, **vecs})
    _build.check_shape(name, "cotangent", cot, (o, p, c))
    for key, t in vecs.items():
        _build.check_shape(name, key, t, (c,))
    grads = torch.zeros(n_grad(c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    if o:
        blocks = _build.grid_blocks(dev, o * ((p + 63) // 64), per_sm=1)
        part, work = _build.scratch(dev, blocks, n_grad(c)), _bwd_work(x)
        _build.launch(name, fn_name, dev,
                      *(t.data_ptr() for t in (x, wqk_s, wv, bv, wt, bt, mask, cot,
                                               *vecs.values(), work, dx, part)),
                      blocks, grads.data_ptr(), o, p, int(double_norm),
                      _build.DTYPE_CODE[dt])
    dwqk, dwv, dbv, dwt, dbt = torch.split(grads, (c * da, c * c, c, c * c, c))
    s = float(da) ** -0.25 if scale else 1.0
    return (dx, s * dwqk.view(c, da), dwv.view(c, c), dbv.view(1, c),
            dwt.view(c, c), dbt.view(1, c))


def block_res_bwd(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, dsum, dsumsq,
                  scale=True, double_norm=False):
    """Backward of the training block for the cotangent ``dxn`` of its
    output, given the fold ``(wbn, bbn)`` [C] and the totals ``dsum,
    dsumsq`` [1, C] of the BN sums' cotangents (f32): ``(dx [O, P, C] in
    x's dtype (the residual included), dwqk [C, da], dwv [C, C],
    dbv [1, C], dwt [C, C], dbt [1, C])``, the weight gradients at the
    accumulation dtype."""
    if x.device.type == "cpu":
        return block_res_bwd_plain(x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn,
                                   dsum, dsumsq, scale, double_norm)
    return _block_backward("pct_block_res_bwd", "sga_pct_block_res_bwd", x, wqk, wv,
                           bv, wt, bt, mask, dxn,
                           (("wbn", wbn), ("bbn", bbn), ("dsum", dsum),
                            ("dsumsq", dsumsq)), scale, double_norm)


def block_bwd(x, wqk, wv, bv, wt, bt, mask, dt, dsum, dsumsq, scale=True,
              double_norm=False):
    """Backward of ``block_fwd`` for the cotangents ``dt [O, P, C]`` (x's
    dtype) of t_out and ``dsum, dsumsq [1, C]`` (f32) of the sums:
    ``(dx (no residual), dwqk, dwv, dbv, dwt, dbt)`` as ``block_res_bwd``."""
    if x.device.type == "cpu":
        return block_bwd_plain(x, wqk, wv, bv, wt, bt, mask, dt, dsum, dsumsq,
                               scale, double_norm)
    return _block_backward("pct_block_bwd", "sga_pct_block_bwd", x, wqk, wv, bv, wt,
                           bt, mask, dt, (("dsum", dsum), ("dsumsq", dsumsq)),
                           scale, double_norm)


class BlockResidual(torch.autograd.Function):
    """Counterpart of ``pct_block_residual``: the training SA/OA block with
    the batch-statistics BN fold and the relu / residual epilogue. Returns
    ``(x_next, ssum, ssumsq)``; the caller updates the running statistics
    from the sums.

    Forward: ``block_fwd`` (kernel), ``fold_from_sums``, ``epilogue`` (plain
    torch elementwise). Backward: ``epi_sums`` (kernel); the fold's vjp on
    [C] vectors (torch autograd), giving the BN parameters' gradients and,
    with the sums' own cotangents, ``dsum`` / ``dsumsq``; then
    ``block_res_bwd`` (kernel). The two kernels must run in this order: the
    fold's vjp needs the first one's sums.

    Under data parallel (``mesh``; ``count`` the whole batch's) the sums are
    summed over the ranks between ``block_fwd`` and the fold, and the
    returned sums are the whole batch's. In the backward ``epi_sums`` and
    the fold's vjp see this rank's rows (the BN parameters' gradients are
    this rank's share, which the train step's gradient sum adds up), and
    ``dsum`` / ``dsumsq`` are summed over the ranks before ``block_res_bwd``:
    the adjoint of the forward's sum."""

    @staticmethod
    def forward(ctx, x, wqk, wv, bv, wt, bt, bn_scale, bn_bias, mask, count,
                scale=True, double_norm=False, eps=1e-5, mesh=None):
        t_out, ssum, ssumsq = block_fwd(x, wqk, wv, bv, wt, bt, mask, scale,
                                        double_norm)
        ssum, ssumsq = reduce_sum(mesh, (ssum, ssumsq))
        w, b = fold_from_sums(bn_scale, bn_bias, ssum, ssumsq, count, eps)
        ctx.save_for_backward(x, wqk, wv, bv, wt, bt, bn_scale, bn_bias, mask,
                              count, t_out, ssum, ssumsq)
        ctx.flags = (scale, double_norm, eps)
        ctx.mesh = mesh
        return epilogue(x, t_out, w, b), ssum, ssumsq

    @staticmethod
    def backward(ctx, dxn, dsum_ct, dsumsq_ct):
        (x, wqk, wv, bv, wt, bt, bn_scale, bn_bias, mask, count, t_out, ssum,
         ssumsq) = ctx.saved_tensors
        scale, double_norm, eps = ctx.flags
        dxn = dxn.contiguous()
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (bn_scale, bn_bias, ssum, ssumsq)]
            wbn, bbn = fold_from_sums(*leaves, count, eps)
        dwbn, dbbn = epi_sums(t_out, wbn.detach(), bbn.detach(), dxn)
        d_scale, d_bias, dssum, dssumsq = torch.autograd.grad(
            (wbn, bbn), leaves, (dwbn[0].to(wbn.dtype), dbbn[0].to(bbn.dtype)))
        acc = dsum_ct.dtype
        dsum, dsumsq = reduce_sum(ctx.mesh, (dssum.to(acc) + dsum_ct,
                                             dssumsq.to(acc) + dsumsq_ct))
        dx, dwqk, dwv, dbv, dwt, dbt = block_res_bwd(
            x, wqk, wv, bv, wt, bt, mask, dxn, wbn.detach(), bbn.detach(),
            dsum, dsumsq, scale, double_norm)
        return (dx, dwqk.to(wqk.dtype), dwv.to(wv.dtype), dbv[0].to(bv.dtype),
                dwt.to(wt.dtype), dbt[0].to(bt.dtype), d_scale, d_bias, None,
                None, None, None, None, None)


class BlockFused(torch.autograd.Function):
    """Counterpart of ``pct_block_fused``: the SA/OA block's ``(t_out, ssum,
    ssumsq)`` with its own backward (``block_fwd``, then ``block_bwd`` for
    the cotangents of all three). The mask gets a zero gradient, as JAX's
    ``jnp.zeros_like(mask)``."""

    @staticmethod
    def forward(ctx, x, wqk, wv, bv, wt, bt, mask, scale=True, double_norm=False):
        ctx.save_for_backward(x, wqk, wv, bv, wt, bt, mask)
        ctx.flags = (scale, double_norm)
        return block_fwd(x, wqk, wv, bv, wt, bt, mask, scale, double_norm)

    @staticmethod
    def backward(ctx, dt, dsum, dsumsq):
        x, wqk, wv, bv, wt, bt, mask = ctx.saved_tensors
        dx, dwqk, dwv, dbv, dwt, dbt = block_bwd(
            x, wqk, wv, bv, wt, bt, mask, dt.contiguous(), dsum, dsumsq, *ctx.flags)
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[6] else None
        return (dx, dwqk.to(wqk.dtype), dwv.to(wv.dtype), dbv[0].to(bv.dtype),
                dwt.to(wt.dtype), dbt[0].to(bt.dtype), dmask, None, None)


def pct_block_fused(x, wqk, wv, bv, wt, bt, mask, scale=True, double_norm=False):
    """The SA/OA block op: ``(t_out [O, P, C], ssum [1, C], ssumsq [1, C])``
    with gradients for x and the five weights. Arguments as ``block_fwd``;
    ``double_norm`` selects the OA normalisation and residual direction."""
    return BlockFused.apply(x, wqk, wv, bv, wt, bt, mask, scale, double_norm)


# --------------------------- the attention op --------------------------------

def attn_fwd_plain(x, wqk, wv, bv, scale=True, double_norm=False):
    q, v = project(x, wqk, wv, bv, scale)
    return attn_core(q, v, double_norm).to(x.dtype)


def attn_fwd(x, wqk, wv, bv, scale=True, double_norm=False):
    """The attention op's forward: ``y [O, P, C]`` in x's dtype, the
    projections and the core with no trans. ``scale`` and ``double_norm``
    are independent: each of the four pairs runs. Weights as in
    ``pct_block_eval``."""
    if x.device.type == "cpu":
        return attn_fwd_plain(x, wqk, wv, bv, scale, double_norm)
    _, suffix = kernel_width("pct_attn_fwd", x)
    name = "pct_attn_fwd" + suffix
    wqk_s = qk_scale(wqk, scale).contiguous()
    o, p, _ = _check_attn(name, x, wqk_s, wv, bv)
    y = torch.empty_like(x)
    if o:
        q, v, lse = _block_work(x)
        _build.launch(name, "sga_pct_attn_fwd" + suffix, x.device,
                      *(t.data_ptr() for t in (x, wqk_s, wv, bv, q, v, lse, y)),
                      o, p, int(double_norm), _build.DTYPE_CODE[x.dtype])
    return y


def attn_bwd_plain(x, wqk, wv, bv, dy, scale=True, double_norm=False):
    qg, vg, y_acc = _recompute(x, wqk, wv, bv, scale, double_norm)
    dx, dwqk, dwv, dbv = _through_core(x, wqk, wv, scale, qg, vg, y_acc,
                                       dy.to(acc_dtype(x.dtype)))
    return dx.to(x.dtype), dwqk, dwv, dbv


def attn_bwd(x, wqk, wv, bv, dy, scale=True, double_norm=False):
    """The attention op's backward for the cotangent ``dy [O, P, C]`` (x's
    dtype) of y: ``(dx [O, P, C] in x's dtype, dwqk [C, da], dwv [C, C],
    dbv [1, C])``, the weight gradients at the accumulation dtype."""
    if x.device.type == "cpu":
        return attn_bwd_plain(x, wqk, wv, bv, dy, scale, double_norm)
    c, suffix = kernel_width("pct_attn_bwd", x)
    name = "pct_attn_bwd" + suffix
    da = c // 4
    wqk_s = qk_scale(wqk, scale).contiguous()
    o, p, _ = _check_attn(name, x, wqk_s, wv, bv)
    _build.check_cuda(name, {"x": x, "dy": dy}, x.dtype)
    _build.check_shape(name, "dy", dy, (o, p, c))
    dev = x.device
    # the first three of a block backward's gradient slices (the C entry
    # reduces only those): dWqk, dWv, dbv
    grads = torch.zeros(c * da + c * c + c, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    if o:
        blocks = _build.grid_blocks(dev, o * ((p + 63) // 64), per_sm=1)
        part, work = _build.scratch(dev, blocks, n_grad(c)), _bwd_work(x)
        _build.launch(name, "sga_pct_attn_bwd" + suffix, dev,
                      *(t.data_ptr() for t in (x, wqk_s, wv, bv, dy, work, dx, part)),
                      blocks, grads.data_ptr(), o, p, int(double_norm),
                      _build.DTYPE_CODE[x.dtype])
    dwqk, dwv, dbv = torch.split(grads, (c * da, c * c, c))
    s = float(da) ** -0.25 if scale else 1.0
    return dx, s * dwqk.view(c, da), dwv.view(c, c), dbv.view(1, c)


class AttentionFused(torch.autograd.Function):
    """Counterpart of ``pct_attention_fused``'s custom VJP: ``attn_fwd``,
    then ``attn_bwd`` for the cotangent of y."""

    @staticmethod
    def forward(ctx, x, wqk, wv, bv, scale=True, double_norm=False):
        ctx.save_for_backward(x, wqk, wv, bv)
        ctx.flags = (scale, double_norm)
        return attn_fwd(x, wqk, wv, bv, scale, double_norm)

    @staticmethod
    def backward(ctx, dy):
        x, wqk, wv, bv = ctx.saved_tensors
        dx, dwqk, dwv, dbv = attn_bwd(x, wqk, wv, bv, dy.contiguous(), *ctx.flags)
        return (dx, dwqk.to(wqk.dtype), dwv.to(wv.dtype), dbv[0].to(bv.dtype),
                None, None)


def pct_attention_fused(x, wqk, wv, bv, scale=True, double_norm=False):
    """SA (``scale=True``) / OA (``scale=False, double_norm=True``)
    attention: ``y [O, P, C]``, the attended features before trans, with
    gradients for x and the three weights. x [O, P, C] (C = 128 or 256,
    da = C / 4); wqk [C, da] (shared q/k, unscaled); wv [C, C]; bv [C]; all
    in x's dtype."""
    return AttentionFused.apply(x, wqk, wv, bv, scale, double_norm)
