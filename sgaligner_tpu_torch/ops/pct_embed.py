"""PCT point embedding: the two conv(no bias) layers of NaivePCT, forward.

Counterpart of ``sgaligner_tpu/ops/pct_embed.py``:

* ``embed_first(x_cf, w, mask)``: channel-first points ``[O, 3, P]`` times
  ``w [3, C]`` -> the pre-BN activation ``h0 [O, P, C]`` (rounded to the
  compute dtype) + masked per-channel sums ``Σh, Σh² [1, C]``.
* ``embed_second(h0, wf, bf, w, mask)``: prologue ``relu(h0·wf + bf)`` (layer
  0's folded BN, at f32 then rounded), times ``w [C, C2]`` -> ``h1`` + sums.

A CUDA tensor goes through the kernels of ``csrc/pct_embed.cu``; a CPU tensor
through the plain versions below, which repeat the kernels' arithmetic
(f64 accumulation for f64 inputs, f32 otherwise).
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import _build


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
    the compute dtype. Returns (h0 [O, P, 128], ssum [1, 128], ssumsq)."""
    if x_cf.device.type == "cpu":
        return embed_first_plain(x_cf, w, mask)
    name = "embed_first"
    _build.check_cuda(name, {"x_cf": x_cf, "w": w, "mask": mask}, x_cf.dtype)
    o, three, p = x_cf.shape
    _build.check_shape(name, "x_cf", x_cf, (o, 3, p))
    _build.check_shape(name, "w", w, (three, 128))
    _build.check_shape(name, "mask", mask, (o, 1))
    h = torch.empty((o, p, 128), dtype=x_cf.dtype, device=x_cf.device)
    s1 = torch.zeros((1, 128), dtype=torch.float32, device=x_cf.device)
    s2 = torch.zeros_like(s1)
    if o:
        _build.launch(name, "sga_embed_first", x_cf.device,
                      x_cf.data_ptr(), w.data_ptr(), mask.data_ptr(),
                      h.data_ptr(), s1.data_ptr(), s2.data_ptr(), o, p,
                      _build.DTYPE_CODE[x_cf.dtype])
    return h, s1, s2


def embed_second(h0, wf, bf, w, mask):
    """h0: [O, P, 128]; wf/bf: [1, 128] folded BN affine; w: [128, 128];
    mask: [O, 1]; all in the compute dtype. Returns (h1, ssum, ssumsq)."""
    if h0.device.type == "cpu":
        return embed_second_plain(h0, wf, bf, w, mask)
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
    s1 = torch.zeros((1, 128), dtype=torch.float32, device=h0.device)
    s2 = torch.zeros_like(s1)
    if o:
        _build.launch(name, "sga_embed_second", h0.device,
                      h0.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                      w.data_ptr(), mask.data_ptr(), h1.data_ptr(),
                      s1.data_ptr(), s2.data_ptr(), o, p,
                      _build.DTYPE_CODE[h0.dtype])
    return h1, s1, s2
