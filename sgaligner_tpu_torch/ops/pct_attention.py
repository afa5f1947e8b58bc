"""PCT self-attention block, inference form (SA and OA flags).

Counterpart of ``sgaligner_tpu/ops/pct_attention.py::pct_block_eval`` and of
the plain composition it is defined by (``_qk_scale``, ``_project``,
``_attn_core``, ``_block_math``, ``_block_eval_ref``). Reference quirks kept:

* q and k share one projection of the same input, so ``E = q qᵀ`` is
  symmetric;
* the softmax normaliser runs over the first energy axis and the attention is
  applied transposed, ``y[j] = Σ_i A[i, j] v[i]`` — the column softmax of E;
* OA (``double_norm=True``) re-normalises the rows by ``1e-9 + Σ``, and its
  residual branch is ``trans(x - attn(x))``;
* SA scales E by ``1/sqrt(da)``, folded into the q/k weight as ``da^-1/4``.

A CUDA tensor goes through ``csrc/pct_attention.cu``; a CPU tensor through
``block_eval_plain``, which repeats the JAX composition op for op (its
exponentials run in the compute dtype against a column max, as the TPU
kernel's do; the CUDA kernel uses an f32 log-sum-exp instead).
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build
from sgaligner_tpu_torch.ops.pct_embed import acc_dtype


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
    """Inference SA/OA block ``x + relu(t_out·wbn + bbn)``.

    x: [O, P, 128]; wqk [128, 32] (unscaled); wv, wt [128, 128]; bv, bt [128]
    in x's dtype; wbn, bbn [128]: the BN affine folded from running
    statistics (at >= f32). ``scale=True, double_norm=False`` is SA,
    ``scale=False, double_norm=True`` OA."""
    if x.device.type == "cpu":
        return block_eval_plain(x, wqk, wv, bv, wt, bt, wbn, bbn, scale,
                                double_norm)
    name = "pct_block_eval"
    if scale == double_norm:
        raise ValueError(f"{name}: takes the SA flags (scale=True, "
                         "double_norm=False) or the OA flags (False, True)")
    dt = x.dtype
    wqk_s = qk_scale(wqk, scale).contiguous()
    wbn32 = wbn.to(torch.float32).reshape(-1).contiguous()
    bbn32 = bbn.to(torch.float32).reshape(-1).contiguous()
    _build.check_cuda(name, {"x": x, "wqk": wqk_s, "wv": wv, "bv": bv,
                             "wt": wt, "bt": bt}, dt)
    _build.check_cuda(name, {"x": x, "wbn": wbn32, "bbn": bbn32})
    o, p, c = x.shape
    _build.check_shape(name, "x", x, (o, p, 128))
    _build.check_shape(name, "wqk", wqk_s, (128, 32))
    for key, t in (("wv", wv), ("wt", wt)):
        _build.check_shape(name, key, t, (128, 128))
    for key, t in (("bv", bv), ("bt", bt), ("wbn", wbn32), ("bbn", bbn32)):
        _build.check_shape(name, key, t, (128,))
    out = torch.empty_like(x)
    q = torch.empty((o, p, 32), dtype=dt, device=x.device)
    v = torch.empty_like(x)
    lse = torch.empty((o, p), dtype=torch.float32, device=x.device)
    if o:
        _build.launch(name, "sga_pct_block_eval", x.device,
                      x.data_ptr(), wqk_s.data_ptr(), wv.data_ptr(),
                      bv.data_ptr(), wt.data_ptr(), bt.data_ptr(),
                      wbn32.data_ptr(), bbn32.data_ptr(), q.data_ptr(),
                      v.data_ptr(), lse.data_ptr(), out.data_ptr(), o, p,
                      int(double_norm), _build.DTYPE_CODE[dt])
    return out
