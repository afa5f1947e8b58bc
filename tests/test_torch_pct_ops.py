"""The port's pct training ops (plain versions, CPU) against the JAX package.

Forward and backward of each autograd Function (``EmbedFirst``,
``EmbedSecond``, ``PctTail``, ``BlockResidual``, and the eval ops' ``BlockEval``
and ``pct_tail_pool``) against the JAX op's custom VJP with the same
cotangents, the tail's saved argmax / argmin, and
``MaskedBatchNorm``'s forms. Widths are NaivePCT's (C=128, da=32; the tail
at K=256), O=16 objects of P=32 points (P=16 with duplicated points for the
tie test), so that every JAX tile picker takes its Pallas kernel; each test
asserts it. Inputs come from numpy with fixed seeds.

* float64 (x64): JAX runs the embedding and tail kernels (forward and
  backward) and ``pct_block_fused`` in Pallas interpret mode; the backward of
  ``pct_block_residual`` runs its pure-JAX fallback (its kernels take
  f32/bf16 only). Both sides compute the same f64 arithmetic in another
  order: rtol 1e-9 with an absolute floor of 1e-9 of the output's largest
  value (a sum of O·P terms that cancels can lose relative accuracy while
  staying that close in absolute terms). A wrong axis, mask, rounding step
  or routing gives errors above 1e-4.
* float32, x64 off: the backward of ``pct_block_residual`` runs the Pallas
  kernels ``_epi_sums_kernel`` and ``_block_res_bwd_kernel`` (interpret
  mode), held normwise (max |error| / max |value| per output) to 1e-5: f32
  sums of up to O·P = 512 products in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.models.pct import MaskedBatchNorm as JaxBN
from sgaligner_tpu.ops import pct_attention as jpa
from sgaligner_tpu.ops import pct_embed as jpe
from sgaligner_tpu.ops import pct_tail as jpt
from sgaligner_tpu_torch.models.pct import MaskedBatchNorm
from sgaligner_tpu_torch.ops.pct_attention import BlockEval, BlockResidual
from sgaligner_tpu_torch.ops.pct_embed import EmbedFirst, EmbedSecond, embed_second_bwd_plain
from sgaligner_tpu_torch.ops.pct_tail import PctTail, pct_tail, pct_tail_pool
from tests.test_torch_ops import expect_dtype, to_jax, x64  # noqa: F401  (fixture)

O, P, C, DA, K = 16, 32, 128, 32, 256
RTOL, FLOOR = 1e-9, 1e-9
F32_NORMWISE = 1e-5


def _mask(rng, o=O):
    m = (rng.random((o, 1)) < 0.75).astype(np.float64)
    m[0] = 1.0
    m[1] = 0.0
    return m


def _close(got, want, what):
    expect_dtype(list(want), what=what)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.float64, f"{what}: output {i} is {g.dtype}"
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=RTOL,
            atol=FLOOR * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what}: output {i}")


def _grads(fn, inputs, cotangents):
    """Port side: outputs and gradients of fn(*inputs) for the cotangents."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    outs = fn(*ts)
    grads = torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cotangents],
                                allow_unused=True)
    return outs, grads


def _block_weights(rng):
    return (rng.normal(size=(C, DA)) / np.sqrt(C), rng.normal(size=(C, C)) / np.sqrt(C),
            rng.normal(size=(C,)) * 0.1, rng.normal(size=(C, C)) / np.sqrt(C),
            rng.normal(size=(C,)) * 0.1, 1.0 + 0.2 * rng.normal(size=(C,)),
            rng.normal(size=(C,)) * 0.1)


# ---------------------------------- eval ops ---------------------------------

@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True), (False, False)],
                         ids=["SA", "OA", "both", "neither"])
def test_block_eval_grads_match_jax(x64, flags):
    """BlockEval (the eval block with gradients) against the JAX
    pct_block_eval and its custom VJP (the reference composition's vjp),
    every flag pair, the mixed ones included."""
    rng = np.random.default_rng(20)
    wqk, wv, bv, wt, bt, wbn, bbn = _block_weights(rng)
    x = rng.normal(size=(O, P, C))
    args = (x, wqk, wv, bv, wt, bt, wbn, bbn)
    ct = rng.normal(size=(O, P, C))
    want, vjp = jax.vjp(lambda *a: jpa.pct_block_eval(*a, *flags, True), *to_jax(*args))
    want_g = vjp(to_jax(ct)[0])
    outs, grads = _grads(lambda *a: BlockEval.apply(*a, *flags), args, [ct])
    _close([outs], [want], f"pct_block_eval {flags} forward")
    _close(grads, want_g, f"pct_block_eval {flags} grads")


def test_pct_tail_pool_matches_jax(x64):
    """The eval tail: with gradients, PctTail's indexed form against the JAX
    op's custom VJP; without, the serving form, the same outputs."""
    rng = np.random.default_rng(21)
    xs, w, m = _tail_inputs(rng)
    cts = (rng.normal(size=(O, K)), rng.normal(size=(O, K)), rng.normal(size=(1, K)),
           rng.normal(size=(1, K)) * 0.05)
    mj = to_jax(m)[0]
    want, vjp = jax.vjp(lambda *a: jpt.pct_tail_fused(*a, mj, True), *to_jax(*xs, w))
    want_g = vjp(tuple(to_jax(*cts)))
    outs, grads = _grads(lambda *a: pct_tail_pool(*a, torch.from_numpy(m)), (*xs, w), cts)
    assert outs[0].grad_fn is not None
    _close(outs, want, "pct_tail_pool forward")
    _close(grads, want_g, "pct_tail_pool grads (dx1..dx4, dw)")
    with torch.no_grad():
        plain = pct_tail_pool(*(torch.from_numpy(a) for a in (*xs, w, m)))
    assert plain[0].grad_fn is None
    _close(plain, want, "pct_tail_pool without gradients")


# ---------------------------------- embedding --------------------------------

def test_embed_first_grad_matches_jax(x64):
    rng = np.random.default_rng(0)
    x, w, m = rng.normal(size=(O, 3, P)), rng.normal(size=(3, C)) * 0.5, _mask(rng)
    cts = (rng.normal(size=(O, P, C)), rng.normal(size=(1, C)), rng.normal(size=(1, C)) * 0.1)
    assert jpe._pick_tile_e(O, P, C, 8, bwd=True) is not None       # Pallas backward
    mj = to_jax(m)[0]
    want, vjp = jax.vjp(lambda x_, w_: jpe.embed_first_fused(x_, w_, mj, True), *to_jax(x, w))
    dx_j, dw_j = vjp(tuple(to_jax(*cts)))
    outs, (dx, dw) = _grads(lambda x_, w_: EmbedFirst.apply(x_, w_, torch.from_numpy(m)),
                            (x, w), cts)
    _close(outs, want, "embed_first forward")
    _close([dw], [dw_j], "embed_first dw")
    assert not bool(dx.any()) and not np.asarray(dx_j).any()       # points are data


def test_embed_second_grads_match_jax(x64):
    rng = np.random.default_rng(1)
    h0 = rng.normal(size=(O, P, C))
    wf, bf = rng.normal(size=(1, C)), rng.normal(size=(1, C)) * 0.1
    w, m = rng.normal(size=(C, C)) / np.sqrt(C), _mask(rng)
    cts = (rng.normal(size=(O, P, C)), rng.normal(size=(1, C)), rng.normal(size=(1, C)) * 0.1)
    assert jpe._pick_tile_e(O, P, C, 8, bwd=True) is not None
    mj = to_jax(m)[0]
    want, vjp = jax.vjp(lambda *a: jpe.embed_second_fused(*a, mj, True),
                        *to_jax(h0, wf, bf, w))
    want_g = vjp(tuple(to_jax(*cts)))
    outs, grads = _grads(lambda *a: EmbedSecond.apply(*a, torch.from_numpy(m)),
                         (h0, wf, bf, w), cts)
    _close(outs, want, "embed_second forward")
    _close(grads, want_g, "embed_second grads (dh0, dwf, dbf, dw)")


def test_embed_second_bwd_plain_ragged_alternating_masks(x64):
    """embed_second_bwd_plain, the semantics the card's kernel is held to, at
    a ragged P (25: the card's 64-row tiles straddle objects) with object
    masks alternating 0 / 1, against the JAX VJP (Pallas kernel, interpret
    mode) at f64: rtol 1e-9 with the absolute floor."""
    rng = np.random.default_rng(6)
    o, p = 16, 25
    h0 = rng.normal(size=(o, p, C))
    wf, bf = rng.normal(size=(1, C)), rng.normal(size=(1, C)) * 0.1
    w = rng.normal(size=(C, C)) / np.sqrt(C)
    m = (np.arange(o) % 2).astype(np.float64).reshape(o, 1)
    cts = (rng.normal(size=(o, p, C)), rng.normal(size=(1, C)), rng.normal(size=(1, C)) * 0.1)
    assert jpe._pick_tile_e(o, p, C, 8, bwd=True) is not None
    mj = to_jax(m)[0]
    _, vjp = jax.vjp(lambda *a: jpe.embed_second_fused(*a, mj, True), *to_jax(h0, wf, bf, w))
    want = vjp(tuple(to_jax(*cts)))
    got = embed_second_bwd_plain(*(torch.from_numpy(a) for a in (h0, wf, bf, w, m, *cts)))
    _close(got, want, "embed_second_bwd_plain (dh0, dwf, dbf, dw)")


def test_embed_second_f32_plain_matches_jax_kernels():
    """x64 off: embed_second's f32 plain versions, forward and backward (what
    the card's f32 kernels are held to), at a ragged P (25) with object masks
    alternating 0 / 1, against the Pallas kernels _e2_fwd_kernel and
    _e2_bwd_kernel at f32 (interpret mode): normwise (max |error| / max
    |value| per output) within 1e-5, f32 sums of up to O·P = 400 products in
    another order."""
    assert not jax.config.jax_enable_x64
    rng = np.random.default_rng(8)
    o, p = 16, 25
    f32 = np.float32
    h0 = rng.normal(size=(o, p, C)).astype(f32)
    wf, bf = rng.normal(size=(1, C)).astype(f32), (rng.normal(size=(1, C)) * 0.1).astype(f32)
    w = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(f32)
    m = (np.arange(o) % 2).astype(f32).reshape(o, 1)
    cts = (rng.normal(size=(o, p, C)).astype(f32), rng.normal(size=(1, C)).astype(f32),
           (rng.normal(size=(1, C)) * 0.1).astype(f32))
    for bwd in (False, True):
        assert jpe._pick_tile_e(o, p, C, 4, bwd=bwd) is not None      # both Pallas kernels
    mj = jnp.asarray(m)
    want, vjp = jax.vjp(lambda *a: jpe.embed_second_fused(*a, mj, True),
                        *(jnp.asarray(a) for a in (h0, wf, bf, w)))
    want_g = vjp(tuple(jnp.asarray(c) for c in cts))
    expect_dtype([want, want_g], jnp.float32, what="JAX f32 embed_second")
    got = EmbedSecond.apply(*(torch.from_numpy(a) for a in (h0, wf, bf, w, m)))
    got_g = embed_second_bwd_plain(*(torch.from_numpy(a) for a in (h0, wf, bf, w, m, *cts)))
    for name, g, wv in zip(("h1", "ssum", "ssumsq", "dh0", "dwf", "dbf", "dw"),
                           (*got, *got_g), (*want, *want_g)):
        assert g.dtype == torch.float32, name
        err = _normwise(g, wv)
        assert err <= F32_NORMWISE, (name, err)


# ------------------------------------ tail -----------------------------------

def _tail_inputs(rng, p=P):
    xs = [rng.normal(size=(O, p, C)) for _ in range(4)]
    return xs, rng.normal(size=(4 * C, K)) / np.sqrt(4 * C), _mask(rng)


def test_pct_tail_grads_match_jax(x64):
    rng = np.random.default_rng(2)
    xs, w, m = _tail_inputs(rng)
    cts = (rng.normal(size=(O, K)), rng.normal(size=(O, K)), rng.normal(size=(1, K)),
           rng.normal(size=(1, K)) * 0.05)
    for bwd in (False, True):
        assert jpt._pick_tile(O, P, K, 8, bwd=bwd) is not None     # both kernels
    mj = to_jax(m)[0]
    want, vjp = jax.vjp(lambda *a: jpt.pct_tail_fused(*a, mj, True), *to_jax(*xs, w))
    want_g = vjp(tuple(to_jax(*cts)))
    outs, grads = _grads(lambda *a: PctTail.apply(*a, torch.from_numpy(m)), (*xs, w), cts)
    _close(outs, want, "pct_tail forward")
    _close(grads, want_g, "pct_tail grads (dx1..dx4, dw)")


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_pct_tail_indices_match_jax(x64, ties):
    """The argmax / argmin outputs equal the JAX forward's saved indices;
    with every point duplicated (rows p and p + 8 equal), each max and min
    is tied and both sides give the first index."""
    rng = np.random.default_rng(3)
    p = 16 if ties else P
    xs, w, m = _tail_inputs(rng, p)
    if ties:
        for x in xs:
            x[:, 8:] = x[:, :8]
    assert jpt._pick_tile(O, p, K, 8, bwd=False) is not None
    outs, kernel_ok = jpt._forward(*to_jax(*xs, w, m), True, save_idx=True)
    assert kernel_ok
    got = pct_tail(*(torch.from_numpy(a) for a in (*xs, w, m)), with_index=True)
    _close(got[:4], outs[:4], "pct_tail forward")
    for g, want in zip(got[4:], outs[4:6]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    if ties:
        assert int(got[4].max()) < 8 and int(got[5].max()) < 8


# ----------------------------------- blocks ----------------------------------

def _block_case(rng):
    x = rng.normal(size=(O, P, C))
    ws = _block_weights(rng)
    m = _mask(rng)
    cts = (rng.normal(size=(O, P, C)), rng.normal(size=(1, C)) * 0.01,
           rng.normal(size=(1, C)) * 0.001)
    return x, ws, m, cts


def _jax_block(x, ws, m, cts, flags, dtype):
    scale, double_norm = flags
    arrs = [jnp.asarray(a, dtype) for a in (x, *ws[:5])]
    bn = [jnp.asarray(a, dtype if dtype == jnp.float64 else jnp.float32) for a in ws[5:]]
    mj = jnp.asarray(m, dtype)
    count = jnp.maximum(mj.astype(jnp.float32).sum() * P, 1.0)
    out, vjp = jax.vjp(lambda *a: jpa.pct_block_residual(
        *a[:6], a[6], a[7], mj, count, scale, double_norm, 1e-5, True), *arrs, *bn)
    acc = dtype if dtype == jnp.float64 else jnp.float32
    grads = vjp((jnp.asarray(cts[0], dtype), jnp.asarray(cts[1], acc),
                 jnp.asarray(cts[2], acc)))
    return out, grads


def _port_block(x, ws, m, cts, flags, dtype):
    scale, double_norm = flags
    count = torch.tensor(max(float(m.sum()) * P, 1.0), dtype=torch.float32)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (x, *ws[:5])]
    bn = [torch.from_numpy(a).to(acc).requires_grad_(True) for a in ws[5:]]
    outs = BlockResidual.apply(*ts, *bn, torch.from_numpy(m).to(dtype), count, scale,
                               double_norm, 1e-5)
    grads = torch.autograd.grad(outs, ts + bn, (torch.from_numpy(cts[0]).to(dtype),
                                                torch.from_numpy(cts[1]).to(acc),
                                                torch.from_numpy(cts[2]).to(acc)))
    return outs, grads


@pytest.mark.parametrize("flags", [(True, False), (False, True)], ids=["SA", "OA"])
def test_block_residual_matches_jax_f64(x64, flags):
    rng = np.random.default_rng(4)
    x, ws, m, cts = _block_case(rng)
    assert jpa._block_pick_tile(O, P, C, DA, 8, bwd=False) is not None  # Pallas forward
    expect_dtype(to_jax(x, *ws, m))
    want, want_g = _jax_block(x, ws, m, cts, flags, jnp.float64)
    got, got_g = _port_block(x, ws, m, cts, flags, torch.float64)
    _close(got, want, "pct_block_residual forward (x_next, ssum, ssumsq)")
    _close(got_g, want_g, "pct_block_residual grads (x, wqk, wv, bv, wt, bt, scale, bias)")


def _normwise(got, want):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def test_block_residual_matches_jax_kernels_f32():
    """x64 off: the JAX backward is the Pallas pair _epi_sums_kernel +
    _block_res_bwd_kernel (interpret mode)."""
    assert not jax.config.jax_enable_x64
    rng = np.random.default_rng(5)
    x, ws, m, cts = _block_case(rng)
    assert jpa._block_pick_tile(O, P, C, DA, 4, bwd=True) is not None
    assert jpa._pick_tile_epi(O, P, C, 4) is not None
    want, want_g = _jax_block(x, ws, m, cts, (True, False), jnp.float32)
    expect_dtype([want, want_g], jnp.float32, what="JAX f32 block")
    got, got_g = _port_block(x, ws, m, cts, (True, False), torch.float32)
    names = ("dx", "dwqk", "dwv", "dbv", "dwt", "dbt", "dscale", "dbias")
    for name, g, w in zip(("x_next", "ssum", "ssumsq") + names, (*got, *got_g),
                          (*want, *want_g)):
        assert g.dtype == torch.float32, name
        err = _normwise(g, w)
        assert err <= F32_NORMWISE, (name, err)


# --------------------------------- batch norm --------------------------------

def _bn_vars(rng, c):
    return {"params": {"scale": 1.0 + 0.3 * rng.normal(size=c),
                       "bias": 0.1 * rng.normal(size=c)},
            "batch_stats": {"mean": 0.2 * rng.normal(size=c),
                            "var": 0.5 + rng.random(c)}}


def _port_bn(v, c):
    bn = MaskedBatchNorm(c).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    return bn


@pytest.mark.parametrize("shape", [(O, P, C), (O, 64)], ids=["points", "objects"])
def test_masked_batchnorm_forms_match_jax(x64, shape):
    """Batch statistics over valid rows (output and running update),
    ``moments=`` with ``return_fold``, and the eval fold."""
    rng = np.random.default_rng(6)
    c = shape[-1]
    x = rng.normal(size=shape) * 2.0 + 0.5
    valid = rng.random(O) < 0.7
    valid[0] = True
    mask = valid[:, None] if len(shape) == 3 else valid
    v = _bn_vars(rng, c)
    jv = expect_dtype(jax.tree.map(jnp.asarray, v))
    jbn = JaxBN(c)
    y_j, upd = jbn.apply(jv, *to_jax(x), jnp.asarray(mask), True, mutable=["batch_stats"])
    bn = _port_bn(v, c).train()
    y = bn(torch.from_numpy(x), torch.from_numpy(mask))
    _close([y], [y_j], "batch statistics: output")
    _close([bn.running_mean, bn.running_var],
           [upd["batch_stats"]["mean"], upd["batch_stats"]["var"]], "running update")

    # moments= with return_fold: the fold from the given moments, and the update
    mean, var = 0.3 * rng.normal(size=c), 0.5 + rng.random(c)
    count = float(valid.sum() * (P if len(shape) == 3 else 1))
    (w_j, b_j), upd = jbn.apply(
        jv, *to_jax(x), jnp.asarray(mask), True,
        moments=(*to_jax(mean, var), jnp.float32(count)), return_fold=True,
        mutable=["batch_stats"])
    bn = _port_bn(v, c).train()
    w, b = bn.train_fold((torch.from_numpy(mean), torch.from_numpy(var),
                          torch.tensor(count, dtype=torch.float32)), torch.float64)
    _close([w, b], [w_j, b_j], "moments fold")
    _close([bn.running_mean, bn.running_var],
           [upd["batch_stats"]["mean"], upd["batch_stats"]["var"]], "moments update")

    # eval: the running-statistics fold, and the moments are ignored
    w_j, b_j = jbn.apply(jv, *to_jax(x), jnp.asarray(mask), False, return_fold=True)
    _close(list(_port_bn(v, c).eval().fold(torch.float64)), [w_j, b_j], "eval fold")


@pytest.mark.parametrize("dtype,width,reads", [(torch.float32, 128, True),
                                               (torch.float32, 256, False),
                                               (torch.bfloat16, 128, False)],
                         ids=["f32-C128", "f32-C256", "bf16-C128"])
def test_attention_alignment_rule_and_cpu_views(dtype, width, reads):
    """The attention wrappers hold a tensor to a 16-byte start only where
    the kernel copies it 16 bytes at a time (the f32 C = 128 passes); a CPU
    tensor takes the plain version, offset view or not."""
    from sgaligner_tpu_torch.ops import pct_attention as pa

    x = torch.zeros(2, 8, width, dtype=dtype)
    assert pa._reads_16(x) is reads
    r = np.random.default_rng(3)
    c = width
    args = [torch.tensor(r.standard_normal(s) * 0.1, dtype=torch.float32)
            for s in ((2, 8, c), (c, c // 4), (c, c), (c,), (c, c), (c,))]
    buf = torch.zeros(args[0].numel() + 1)
    view = buf[1:].view(args[0].shape)
    view.copy_(args[0])
    mask = torch.ones(2, 1)
    got = pa.block_fwd(view, *args[1:], mask)
    want = pa.block_fwd_plain(args[0], *args[1:], mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_check_aligned_refuses_offset_views(offset):
    """The f32 tail's wrappers refuse a tensor that does not start at a
    16-byte boundary (its kernels read it 16 bytes at a time)."""
    from sgaligner_tpu_torch.ops import _build

    buf = torch.zeros(4 * 128 + 4)
    view = buf[offset:offset + 4 * 128].view(4, 128)
    if offset % 4:
        with pytest.raises(ValueError, match="16-byte boundary"):
            _build.check_aligned("pct_tail_bwd", {"dsum": view})
    else:
        _build.check_aligned("pct_tail_bwd", {"dsum": view})


@pytest.mark.parametrize("width,oa", [(128, 0), (128, 1), (256, 1)],
                         ids=["C128-SA", "C128-OA", "C256-OA"])
def test_bwd_work_asks_for_the_form(monkeypatch, width, oa):
    """The backwards' work buffer is sized by the C entry for the form that
    runs: its width's query gets the object count, points, whether the form
    is OA (the f32 C = 128 SA form carves no OA buffer) and the dtype, and
    the buffer has the bytes it answers."""
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.ops import pct_attention as pa

    asked = []

    class Lib:
        def __getattr__(self, name):
            def query(*args):
                asked.append((name, args))
                return 1000 + 10 * args[2]
            return query

    monkeypatch.setattr(_build, "lib", lambda: Lib())
    x = torch.zeros(3, 7, width)
    work = pa._bwd_work(x, bool(oa))
    suffix = "" if width == 128 else "_c256"
    assert asked == [("sga_pct_bwd_work_bytes" + suffix,
                      (3, 7, oa, _build.DTYPE_CODE[torch.float32]))]
    assert work.dtype == torch.uint8 and work.numel() == 1000 + 10 * oa
