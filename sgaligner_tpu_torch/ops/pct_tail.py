"""PCT tail, forward: concat(4 SA outputs) -> 1024-wide projection -> pool.

Counterpart of ``sgaligner_tpu/ops/pct_tail.py::pct_tail_fused`` (forward,
without the argmax/argmin outputs the training backward saves). It returns
the per-object, per-channel max and min of ``z = concat(x) @ w`` over points
and the masked BN sums of z; the caller rebuilds the reference's
BN -> LeakyReLU -> max-pool with the exact monotone identity
``max_p leaky(w·z_p + b) = leaky(w·(max_p z if w > 0 else min_p z) + b)``.

A CUDA tensor goes through ``csrc/pct_tail.cu``; a CPU tensor through
``pct_tail_plain``.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build
from sgaligner_tpu_torch.ops.pct_embed import acc_dtype


def pct_tail_plain(x1, x2, x3, x4, w, mask):
    acc = acc_dtype(x1.dtype)
    z = torch.matmul(torch.cat([x1, x2, x3, x4], dim=-1).to(acc),
                     w.to(acc)).to(x1.dtype).to(acc)              # [O, P, K]
    m = mask.to(acc)
    return (z.amax(dim=1), z.amin(dim=1),
            (z.sum(1) * m).sum(0, keepdim=True),
            ((z * z).sum(1) * m).sum(0, keepdim=True))


def pct_tail(x1, x2, x3, x4, w, mask):
    """x_i: [O, P, 128] SA-block outputs; w: [512, K] (K a multiple of 128);
    mask: [O, 1] (1 = valid object); all in the compute dtype. Returns
    ``(pmax [O, K], pmin [O, K], ssum [1, K], ssumsq [1, K])`` at f32 (f64
    for f64 inputs)."""
    if x1.device.type == "cpu":
        return pct_tail_plain(x1, x2, x3, x4, w, mask)
    name = "pct_tail"
    _build.check_cuda(name, {"x1": x1, "x2": x2, "x3": x3, "x4": x4, "w": w,
                             "mask": mask}, x1.dtype)
    o, p, c = x1.shape
    k = w.shape[-1]
    for key, t in (("x1", x1), ("x2", x2), ("x3", x3), ("x4", x4)):
        _build.check_shape(name, key, t, (o, p, 128))
    if k % 128:
        raise ValueError(f"{name}: K = {k} is not a multiple of 128")
    _build.check_shape(name, "w", w, (512, k))
    _build.check_shape(name, "mask", mask, (o, 1))
    dev = x1.device
    pmax = torch.empty((o, k), dtype=torch.float32, device=dev)
    pmin = torch.empty_like(pmax)
    s1 = torch.zeros((1, k), dtype=torch.float32, device=dev)
    s2 = torch.zeros_like(s1)
    if o:
        _build.launch(name, "sga_pct_tail", dev,
                      x1.data_ptr(), x2.data_ptr(), x3.data_ptr(),
                      x4.data_ptr(), w.data_ptr(), mask.data_ptr(),
                      pmax.data_ptr(), pmin.data_ptr(), s1.data_ptr(),
                      s2.data_ptr(), o, p, k, _build.DTYPE_CODE[x1.dtype])
    return pmax, pmin, s1, s2
