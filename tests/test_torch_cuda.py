"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. On a machine
with one (and nvcc), from the repo root:

    python -m pytest tests/test_torch_cuda.py -q

The inputs, wrappers and tolerances are chip_smoke.py's (its ``kernels``
phase runs the same comparisons at full width).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

SA, OA = (True, False), (False, True)
CASES = [("embed_first", None), ("embed_second", None),
         ("pct_block_eval", SA), ("pct_block_eval", OA),
         ("pct_tail", None), ("pct_tail", "idx"), ("pointnet_fwd", None),
         ("pointnet_bwd", None), ("embed_first_bwd", None),
         ("embed_second_bwd", None), ("pct_block_fwd", None),
         ("pct_epi_sums", None), ("pct_block_res_bwd", None),
         ("pct_tail_bwd", None), ("pct_block_fwd", OA), ("pct_block_res_bwd", OA),
         ("pct_attn_fwd", SA), ("pct_attn_fwd", OA), ("pct_attn_bwd", SA),
         ("pct_attn_bwd", OA), ("pct_block_bwd", SA), ("pct_block_bwd", OA)]

# The autograd Functions on the card, at f32, are held to the CPU's plain
# versions at f64: no further than the last kernel's f32 tolerance plus
# CHAIN_VS_CPU times the CPU's own f32 distance from f64. The block's
# Function runs the BN fold's vjp between its kernels, where the one-pass
# variance cancels, so f32 on either side sits far from f64 there (on an
# H100: the card 4.8e-3, the CPU 4.1e-3); the other chains are well
# conditioned (below 2e-6 on both sides) and the kernel tolerance dominates
CHAIN_VS_CPU = 4.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("points", [512, 72])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,flags", CASES,
                         ids=["embed_first", "embed_second", "block_SA",
                              "block_OA", "pct_tail", "pct_tail_idx",
                              "pointnet_fwd", "pointnet_bwd", "embed_first_bwd",
                              "embed_second_bwd", "block_fwd", "epi_sums",
                              "block_res_bwd", "pct_tail_bwd", "block_fwd_OA",
                              "block_res_bwd_OA", "attn_fwd_SA", "attn_fwd_OA",
                              "attn_bwd_SA", "attn_bwd_OA", "block_bwd_SA",
                              "block_bwd_OA"])
def test_kernel_matches_plain_version(card, name, flags, dtype, points):
    """check_op raises past the tolerance (and, for the PointNet forward
    and the tail's indexed form, when an index points off the max / min)."""
    from sgaligner_tpu_torch.ops import _build

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.op_inputs(name, 37, dt, seed=5, p=points)
    before = _build.LAUNCHES[name]
    card.check_op(name, args, dtype, flags or SA)
    assert _build.LAUNCHES[name] == before + 1


def test_pointnet_autograd_and_determinism(card):
    """The autograd Function on the card: forward with argmax and backward
    kernel, one launch each, a zero x gradient, weight gradients equal to
    the plain backward's; the backward gives the same bits twice (no
    atomics)."""
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.ops.pointnet_fused import (pointnet_bwd,
                                                        pointnet_bwd_plain,
                                                        pointnet_fused,
                                                        pointnet_pool_plain)

    x, *ws = card.op_inputs("pointnet_fwd", 37, torch.float32, seed=6)
    x.requires_grad_(True)
    ws = [w.requires_grad_(True) for w in ws]
    dout = torch.randn(37, ws[-1].shape[-1], device="cuda")
    before = dict(_build.LAUNCHES)
    out = pointnet_fused(x, *ws)
    grads = torch.autograd.grad(out, [x, *ws], dout)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pointnet_fwd"] == before["pointnet_fwd"] + 1
    assert _build.LAUNCHES["pointnet_bwd"] == before["pointnet_bwd"] + 1
    assert not bool(grads[0].any())
    with torch.no_grad():
        peak, amax = pointnet_pool_plain(x, *ws, with_argmax=True)
        want = pointnet_bwd_plain(x, dout, amax, peak, *ws)
        _, rel = card.compare(tuple(grads[1:]), want)
        assert rel <= card.TOL[("pointnet_bwd", "f32")]
        first = pointnet_bwd(x, dout, amax, peak, *ws)
        second = pointnet_bwd(x, dout, amax, peak, *ws)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_pct_autograd_functions_and_determinism(card):
    """The pct training Functions on the card: one forward and one backward
    launch each, gradients held to the plain versions' at f64 on the same
    inputs (CHAIN_VS_CPU); every backward kernel gives the same bits twice
    (no atomics)."""
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.ops.pct_attention import BlockResidual
    from sgaligner_tpu_torch.ops.pct_embed import EmbedFirst, EmbedSecond
    from sgaligner_tpu_torch.ops.pct_tail import PctTail

    o = 37
    x, w, mask = card.op_inputs("embed_first", o, torch.float32, seed=7)
    h0, wf, bf, w1, _ = card.op_inputs("embed_second", o, torch.float32, seed=7)
    blk = card.op_inputs("pct_block_fwd", o, torch.float32, seed=7)
    tail = card.op_inputs("pct_tail", o, torch.float32, seed=7)
    count = torch.clamp_min(mask.sum() * card.P, 1.0)
    g = torch.Generator().manual_seed(7)
    bn = (torch.rand(card.C, generator=g) + 0.5, torch.randn(card.C, generator=g) * 0.1)

    def cases(dev, dtype):
        """label -> (Function call, its differentiable inputs, kernels in
        launch order); every tensor on ``dev`` in ``dtype``."""
        m, cnt, tm = (t.to(dev, dtype) for t in (mask, count, tail[5]))
        return {
            "embed_first": (lambda *a: EmbedFirst.apply(*a, m), (x, w),
                            ("embed_first", "embed_first_bwd")),
            "embed_second": (lambda *a: EmbedSecond.apply(*a, m), (h0, wf, bf, w1),
                             ("embed_second", "embed_second_bwd")),
            "block": (lambda *a: BlockResidual.apply(*a, m, cnt), (*blk[:6], *bn),
                      ("pct_block_fwd", "pct_epi_sums", "pct_block_res_bwd")),
            "tail": (lambda *a: PctTail.apply(*a, tm), tail[:5],
                     ("pct_tail", "pct_tail_bwd")),
        }

    for label in cases("cpu", torch.float32):
        grads = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            fn, inputs, kernels = cases(dev, dtype)[label]
            leaves = [t.detach().to(dev, dtype).requires_grad_(True) for t in inputs]
            before = dict(_build.LAUNCHES)
            outs = fn(*leaves)
            # the [1, C] sums' cotangents at 1/count, as in the model, where
            # the sums reach the loss as moments (sums / count)
            gen = torch.Generator().manual_seed(1)
            cts = [torch.randn(t.shape, generator=gen).to(t)
                   / (float(count) if t.shape[0] == 1 else 1.0) for t in outs]
            grads[dev, dtype] = tuple(t.cpu().double() for t in
                                      torch.autograd.grad(outs, leaves, cts))
            if dev == "cuda":
                torch.cuda.synchronize()
                for name in kernels:
                    assert _build.LAUNCHES[name] == before[name] + 1, (label, name)
        ref = grads["cpu", torch.float64]
        _, card_rel = card.compare(grads["cuda", torch.float32], ref)
        _, cpu_rel = card.compare(grads["cpu", torch.float32], ref)
        bound = card.TOL[(kernels[-1], "f32")] + CHAIN_VS_CPU * cpu_rel
        assert card_rel <= bound, (label, card_rel, cpu_rel)
    for name in ("embed_first_bwd", "embed_second_bwd", "pct_epi_sums",
                 "pct_block_res_bwd", "pct_tail_bwd"):
        kern, _ = card.op_fns(name)
        args = card.op_inputs(name, o, torch.bfloat16, seed=8)
        first, second = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
        assert all(torch.equal(a, b) for a, b in zip(first, second)), name


@pytest.mark.parametrize("flags", [SA, OA], ids=["SA", "OA"])
def test_attention_ops_autograd_and_determinism(card, flags):
    """AttentionFused and BlockFused on the card at f32: one launch of each
    of their kernels, gradients held to the plain versions' at f64 on the
    same inputs (their backward kernel's f32 tolerance plus CHAIN_VS_CPU
    times the CPU's own f32 distance); each backward gives the same bits
    twice."""
    from sgaligner_tpu_torch.ops import _build

    o = 37
    for op, fwd, bwd in (("attention", "pct_attn_fwd", "pct_attn_bwd"),
                         ("block", "pct_block_fwd", "pct_block_bwd")):
        args = card.op_inputs(bwd, o, torch.float32, seed=9)
        grads = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            before = dict(_build.LAUNCHES)
            grads[dev, dtype] = card._op_grads(op, flags, dev, dtype, args)
            if dev == "cuda":
                torch.cuda.synchronize()
                for name in (fwd, bwd):
                    assert _build.LAUNCHES[name] == before[name] + 1, (op, name)
        ref = grads["cpu", torch.float64]
        _, card_rel = card.compare(grads["cuda", torch.float32], ref)
        _, cpu_rel = card.compare(grads["cpu", torch.float32], ref)
        assert card_rel <= card.TOL[(bwd, "f32")] + CHAIN_VS_CPU * cpu_rel, (op, card_rel)
        kern, _ = card.op_fns(bwd, flags)
        bf = card.op_inputs(bwd, o, torch.bfloat16, seed=10)
        first, second = card.as_tuple(kern(*bf)), card.as_tuple(kern(*bf))
        assert all(torch.equal(a, b) for a, b in zip(first, second)), bwd


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spct_on_the_card_matches_the_cpu(card, train):
    """SPCT on the card at f32 against its CPU path (plain versions) at f32
    and f64, the same seeded weights and points: the three outputs, and in
    train mode the running statistics and every parameter gradient for
    seeded cotangents (quiet leaves, ``quiet_leaves``, left out: the biases
    right before a batch-statistics BatchNorm). Each reading of the card,
    its distance from the f64 run, is held to chip_smoke's PCT_VS_CPU times
    the CPU's own f32 distance (one-pass BatchNorm moments cancel in f32)."""
    from sgaligner_tpu_torch.engine.factory import init_weights
    from sgaligner_tpu_torch.models.pct import SPCT
    from sgaligner_tpu_torch.ops import _build

    g = torch.Generator().manual_seed(12)
    pts = torch.randn(37, card.P, 3, generator=g)
    mask = torch.rand(37, generator=g) < 0.85
    runs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        net = SPCT(dtype)
        init_weights(net, torch.Generator().manual_seed(13))
        net = net.to(dev, dtype).train(train)
        before = dict(_build.LAUNCHES)
        with torch.set_grad_enabled(train):
            outs = net(pts.to(dev, dtype), mask.to(dev))
        read = {f"output {i}": t.detach() for i, t in enumerate(outs)}
        if train:
            gc = torch.Generator().manual_seed(14)
            cts = [torch.randn(t.shape, generator=gc).to(dev, dtype) for t in outs]
            names, prms = zip(*net.named_parameters())
            read.update(zip(names, torch.autograd.grad(outs, prms, cts)))
            read.update((k, v) for k, v in net.state_dict().items() if "running_" in k)
        if dev == "cuda":
            torch.cuda.synchronize()
            blocks = "pct_block_fwd" if train else "pct_block_eval"
            assert _build.LAUNCHES[blocks] == before[blocks] + 4
        runs[dev, dtype] = {k: v.double().cpu() for k, v in read.items()}
    ref = runs["cpu", torch.float64]
    quiet = card.quiet_leaves({k: v for k, v in ref.items() if "." in k
                               and "running_" not in k}) if train else set()
    for k, v in ref.items():
        if k in quiet:
            continue
        dist = {key: float((run[k] - v).norm() / v.norm().clamp_min(1e-30))
                for key, run in runs.items() if key != ("cpu", torch.float64)}
        assert dist["cuda", torch.float32] <= card.PCT_VS_CPU * dist["cpu", torch.float32] + 1e-6, \
            (k, dist)


def test_wrappers_raise_instead_of_falling_back(card):
    from sgaligner_tpu_torch.ops.pct_embed import embed_first
    from sgaligner_tpu_torch.ops.pct_tail import pct_tail

    x, w, mask = card.op_inputs("embed_first", 8, torch.float32, seed=0)
    with pytest.raises(ValueError):                  # float64 has no kernel
        embed_first(x.double(), w.double(), mask.double())
    with pytest.raises(ValueError):                  # not contiguous
        embed_first(x.transpose(1, 2).contiguous().transpose(1, 2), w, mask)
    args = card.op_inputs("pct_tail", 8, torch.bfloat16, seed=0)
    with pytest.raises(ValueError):                  # K not a multiple of 128
        pct_tail(*args[:4], args[4][:, :100].contiguous(), args[5])
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_fwd

    x, *ws = card.op_inputs("pointnet_fwd", 8, torch.float32, seed=0)
    with pytest.raises(ValueError):                  # weights on the CPU
        pointnet_fwd(x, *(w.cpu() for w in ws))
    # the f32 PointNet kernels take any C3 and the bf16 wrappers pad it
    # (EVA's 200 and 100: test_pointnet_bwd_f32_widths and the bf16 widths
    # tests); wrong shapes, dtypes and devices still raise
    x, dout, amax, peak, *ws = card.op_inputs("pointnet_bwd", 8, torch.float32, seed=0,
                                              c3=200)
    with pytest.raises(ValueError):                  # weights on the CPU
        pointnet_bwd(x, dout, amax, peak, *(w.cpu() for w in ws))
    with pytest.raises(ValueError):                  # dout one channel short
        pointnet_bwd(x, dout[:, :-1].contiguous(), amax, peak, *ws)
    with pytest.raises(ValueError):                  # peak not float32
        pointnet_bwd(x, dout, amax, peak.double(), *ws)


@pytest.mark.parametrize("points", [64, 200, 512])
@pytest.mark.parametrize("objects", [1, 3, 67])
@pytest.mark.parametrize("name,flags", [("pct_block_eval", SA), ("pct_block_eval", OA),
                                        ("pct_tail", None), ("pct_tail", "idx"),
                                        ("pct_block_fwd", SA), ("pct_block_fwd", OA),
                                        ("embed_second", None), ("pointnet_fwd", None)],
                         ids=["block_SA", "block_OA", "pct_tail", "pct_tail_idx",
                              "block_fwd_SA", "block_fwd_OA", "embed_second", "pointnet_fwd"])
def test_wgmma_kernels_match_plain_version(card, name, flags, objects, points):
    """The wgmma forwards (bf16) at few objects (a block with one or no
    object for one of its warpgroups) and at P a multiple of the 64-row
    tile, ragged, and the main path's. The PointNet forward runs with the
    argmax (held by value) and without it (the same values)."""
    args = card.op_inputs(name, objects, torch.bfloat16, seed=7, p=points)
    card.check_op(name, args, "bf16", flags or SA)
    if name == "pointnet_fwd":
        from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd

        out, amax = pointnet_fwd(*args, with_argmax=True)
        alone, none = pointnet_fwd(*args, with_argmax=False)
        torch.cuda.synchronize()
        assert none is None and torch.equal(out, alone)


@pytest.mark.parametrize("width", [32, 128, 208, 384, 512])
def test_pointnet_fwd_bf16_widths(card, width):
    """The bf16 PointNet forward at C3 other than the model's 256: one
    group of 128 channels (32 padded with zero channels), one of 256 (208
    padded), and groups of 256 across the grid (384 padded to 512, and 512),
    held to the plain version as at 256, with the argmax."""
    x, *ws = card.op_inputs("pointnet_fwd", 67, torch.bfloat16, seed=9, p=200)
    g = torch.Generator().manual_seed(10)
    w3 = (torch.randn(128, width, generator=g) * 128 ** -0.5).to("cuda", torch.bfloat16)
    b3 = (torch.randn(1, width, generator=g) * 0.1).to("cuda", torch.bfloat16)
    args = (x, *ws[:4], w3, b3)
    card.check_op("pointnet_fwd", args, "bf16")
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd

    out, amax = pointnet_fwd(*args, with_argmax=True)
    torch.cuda.synchronize()
    assert out.shape == (67, width) and amax.shape == (67, width) and amax.is_contiguous()


def test_embed_second_sums_across_straddling_tiles(card):
    """embed_second at P = 200 with object masks alternating 0 / 1: its flat
    64-row tiles straddle objects of different masks, and each row must
    count under its own object's mask."""
    args = list(card.op_inputs("embed_second", 67, torch.bfloat16, seed=19, p=200))
    args[4] = (torch.arange(67, device="cuda") % 2).to(torch.bfloat16).reshape(67, 1)
    card.check_op("embed_second", tuple(args), "bf16")


def test_embed_second_bwd_sums_across_straddling_tiles(card):
    """embed_second_bwd at P = 200 with object masks alternating 0 / 1: each
    row's dz takes its own object's mask, in tiles that straddle objects."""
    args = list(card.op_inputs("embed_second_bwd", 67, torch.bfloat16, seed=19, p=200))
    args[4] = (torch.arange(67, device="cuda") % 2).to(torch.bfloat16).reshape(67, 1)
    card.check_op("embed_second_bwd", tuple(args), "bf16")


def test_pointnet_fwd_first_index_and_nan(card):
    """The bf16 PointNet forward: object 0 repeats point 5 at point 70 (in
    another 64-point tile), scaled up so that many channels' max lie on that
    pair; the index must be the first one. Object 2 holds a NaN in x at
    points 7 and 140: every channel's max is NaN, at point 7. Object 1
    agrees with the plain version."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd, pointnet_fwd_plain

    x, *ws = card.op_inputs("pointnet_fwd", 3, torch.float32, seed=3, p=200)
    x[0, :, 5] *= 8.0
    x[0, :, 70] = x[0, :, 5]
    x[2, 0, 7] = float("nan")
    x[2, 1, 140] = float("nan")
    args = [x.to(torch.bfloat16)] + [w.to(torch.bfloat16) for w in ws]
    out, amax = pointnet_fwd(*args, with_argmax=True)
    want, want_idx = pointnet_fwd_plain(*args, with_argmax=True)
    torch.cuda.synchronize()
    tied = (want_idx[0] == 5) | (want_idx[0] == 70)
    assert bool(tied.float().mean() > 0.2)
    assert bool((amax[0][tied] == 5).all()) and not bool((amax[0] == 70).any())
    torch.testing.assert_close(out[0].float(), want[0].float(), rtol=1e-2, atol=1e-2)
    assert bool(out[2].isnan().all()) and bool((amax[2] == 7).all())
    torch.testing.assert_close(out[1].float(), want[1].float(), rtol=1e-2, atol=1e-2)


def test_pointnet_bwd_takes_the_new_forwards_argmax(card):
    """The bf16 forward's argmax and max fed to pointnet_bwd against the
    plain backward fed the same, within pointnet_bwd's bf16 tolerance."""
    from sgaligner_tpu_torch.ops.pointnet_fused import (pointnet_bwd, pointnet_bwd_plain,
                                                        pointnet_pool)

    x, *ws = card.op_inputs("pointnet_fwd", 67, torch.bfloat16, seed=21)
    peak, amax = pointnet_pool(x, *ws, with_argmax=True)
    dout = torch.randn(67, ws[-1].shape[-1], generator=torch.Generator().manual_seed(22)).to(
        "cuda", torch.bfloat16)
    got = pointnet_bwd(x, dout, amax, peak, *ws)
    want = pointnet_bwd_plain(x, dout, amax, peak, *ws)
    torch.cuda.synchronize()
    _, rel = card.compare(got, want)
    assert rel <= card.TOL[("pointnet_bwd", "bf16")], rel


def _pointnet_bwd_args(card, x, ws, seed):
    """pointnet_bwd's inputs on the card: a seeded cotangent, the plain
    forward's argmax and max (both sides get them)."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_pool_plain

    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(x.shape[0], ws[4].shape[1], generator=g).to("cuda", x.dtype)
    peak, amax = pointnet_pool_plain(x, *ws, with_argmax=True)
    return (x, dout, amax, peak, *ws)


def _bwd_tiles_match(card, args):
    """The row tiles the kernels ran are the ones the routing fills."""
    from sgaligner_tpu_torch.ops import pointnet_fused

    pointnet_fused.pointnet_bwd(*args)
    rows, _, tiles = card.bwd_work(args)
    assert int(float(pointnet_fused.last_bwd_grads[-1])) == tiles
    return rows


@pytest.mark.parametrize("objects", [1, 3, 67])
@pytest.mark.parametrize("points", [200, 512])
@pytest.mark.parametrize("width", [32, 128, 208, 256, 384])
def test_pointnet_bwd_bf16_widths(card, width, points, objects):
    """The bf16 backward over the routed rows against the plain (dense)
    version at C3 in {32, 128, 208, 256, 384} (W3 resident at two
    warpgroups a block up to 256, at one above), P a multiple of 8 or not,
    and 1, 3 or 67 objects; it runs as many 64-row tiles as the routed rows
    fill."""
    x, *ws = card.op_inputs("pointnet_fwd", objects, torch.bfloat16, seed=23, p=points)
    g = torch.Generator().manual_seed(24)
    ws[4] = (torch.randn(128, width, generator=g) * 128 ** -0.5).to("cuda", torch.bfloat16)
    ws[5] = (torch.randn(1, width, generator=g) * 0.1).to("cuda", torch.bfloat16)
    args = _pointnet_bwd_args(card, x, ws, seed=25)
    card.check_op("pointnet_bwd", args, "bf16")
    _bwd_tiles_match(card, args)


def test_pointnet_bwd_restages_w3_when_it_does_not_fit(card):
    """At C3 = 640 W3 (160 KB) does not fit in shared memory beside a
    warpgroup's buffers: the backward restages it in groups of 512 channels
    per tile. Against the plain version, with the tiles the routing fills."""
    x, *ws = card.op_inputs("pointnet_fwd", 67, torch.bfloat16, seed=36, p=512)
    g = torch.Generator().manual_seed(37)
    ws[4] = (torch.randn(128, 640, generator=g) * 128 ** -0.5).to("cuda", torch.bfloat16)
    ws[5] = (torch.randn(1, 640, generator=g) * 0.1).to("cuda", torch.bfloat16)
    args = _pointnet_bwd_args(card, x, ws, seed=38)
    card.check_op("pointnet_bwd", args, "bf16")
    _bwd_tiles_match(card, args)


def test_pointnet_bwd_ties_dead_and_many_rows(card):
    """The bf16 backward (O=8, P=512, C3=256): object 0 repeats point 5 at
    point 70 (another 64-point tile of the forward), scaled so that a
    quarter of its channels tie there (the first index routes); object 6's
    points lie on a sphere, so its maxima scatter over more than two
    64-row tiles; object 7's points are scaled down and b3 set so that all
    its channels are dead (max <= 0). Against the plain version, the same
    bits twice, and the tiles the routing fills."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, stack_plain

    x, *ws = card.op_inputs("pointnet_fwd", 8, torch.bfloat16, seed=29, p=512)
    x[0, :, 5] *= 30.0
    x[0, :, 70] = x[0, :, 5]
    xs = x[6].float()
    x[6] = (xs / xs.norm(dim=0, keepdim=True) * 2.0).to(torch.bfloat16)
    x[7] *= 0.05
    a3 = stack_plain(x[7:8], *ws[:5], torch.zeros_like(ws[5]))[0]
    ws[5] = (-a3[0].amax(dim=0, keepdim=True) - 0.05).to(torch.bfloat16)
    args = _pointnet_bwd_args(card, x, ws, seed=30)
    _, _, amax, peak = args[:4]
    assert not bool((peak[7] > 0).any())
    assert bool(((amax[0] == 5).float().mean() > 0.1)) and not bool((amax[0] == 70).any())
    card.check_op("pointnet_bwd", args, "bf16")
    first, second = pointnet_bwd(*args), pointnet_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    live = (peak > 0) & (args[1] != 0)
    routed_6 = len(set(amax[6][live[6]].tolist()))
    assert routed_6 > 128, routed_6
    _bwd_tiles_match(card, args)


def test_pointnet_bwd_nan_point(card):
    """The bf16 backward with a NaN in object 1's x at points 7 and 140:
    every channel's max is NaN there and routes nothing, and the weight
    gradients are NaN where the dense plain version's are (its 0·NaN),
    the bias gradients finite and within the tolerance."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_bwd_plain

    x, *ws = card.op_inputs("pointnet_fwd", 3, torch.bfloat16, seed=31, p=200)
    x[1, 0, 7] = float("nan")
    x[1, 1, 140] = float("nan")
    args = _pointnet_bwd_args(card, x, ws, seed=32)
    assert bool(args[3][1].isnan().all()) and bool((args[2][1] == 7).all())
    got, want = pointnet_bwd(*args), pointnet_bwd_plain(*args)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.isnan(), w.isnan()), i
        if i % 2:   # the bias gradients
            _, rel = card.compare(g, w)
            assert rel <= card.TOL[("pointnet_bwd", "bf16")], (i, rel)
    assert bool(got[4].isnan().all()) and not bool(got[0][2].isnan().any())


def test_pointnet_bwd_routes_by_the_forward_max(card):
    """A channel whose bf16 forward max is positive carries its gradient:
    with b3 set so that each channel's maxima straddle 0 over the objects
    (some within a bf16 step of it) and no cotangent near 0, db3 equals
    Σ_o dout·[peak > 0] of the forward kernel's own f32 max."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_pool, stack_plain

    x, *ws = card.op_inputs("pointnet_fwd", 67, torch.bfloat16, seed=33, p=512)
    a3 = stack_plain(x, *ws[:5], torch.zeros_like(ws[5]))[0]
    ws[5] = (-a3.amax(dim=1).median(dim=0, keepdim=True).values).to(torch.bfloat16)
    peak, amax = pointnet_pool(x, *ws, with_argmax=True)
    pos = (peak > 0).float().mean(dim=0)
    assert bool(((pos > 0) & (pos < 1)).float().mean() > 0.9)
    g = torch.Generator().manual_seed(34)
    mag = 0.5 + torch.rand(67, ws[4].shape[1], generator=g)
    sign = torch.where(torch.rand(67, ws[4].shape[1], generator=g) < 0.5, -1.0, 1.0)
    dout = (mag * sign).to("cuda", torch.bfloat16)
    db3 = pointnet_bwd(x, dout, amax, peak, *ws)[5]
    want = (dout.double() * (peak > 0)).sum(dim=0, keepdim=True)
    torch.testing.assert_close(db3.double(), want, rtol=0, atol=1e-3)


F32_WIDTHS = [16, 100, 200, 208, 256, 384]


def _f32_weights(card, objects, points, width, seed):
    """f32 PointNet inputs on the card with W3 and b3 at ``width`` channels."""
    x, *ws = card.op_inputs("pointnet_fwd", objects, torch.float32, seed=seed, p=points)
    g = torch.Generator().manual_seed(seed + 1)
    ws[4] = (torch.randn(128, width, generator=g) * 128 ** -0.5).cuda()
    ws[5] = (torch.randn(1, width, generator=g) * 0.1).cuda()
    return x, ws


@pytest.mark.parametrize("objects", [1, 3, 67])
@pytest.mark.parametrize("points", [200, 512])
@pytest.mark.parametrize("width", F32_WIDTHS)
def test_pointnet_fwd_f32_widths(card, width, points, objects):
    """The f32 PointNet forward at any C3 (16 to 384: one group of
    resident W3 channels up to 256, two above; widths not a multiple of 8
    or 16), P a multiple of the 64-point tile or not, 1, 3 or 67 objects:
    against the plain version with the argmax held by value, the same bits
    twice, and the same values without the argmax."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd

    x, ws = _f32_weights(card, objects, points, width, seed=51)
    args = (x, *ws)
    card.check_op("pointnet_fwd", args, "f32")
    first = pointnet_fwd(*args, with_argmax=True)
    second = pointnet_fwd(*args, with_argmax=True)
    alone, none = pointnet_fwd(*args, with_argmax=False)
    torch.cuda.synchronize()
    assert first[0].shape == (objects, width) and first[1].is_contiguous()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert none is None and torch.equal(first[0], alone)


@pytest.mark.parametrize("objects", [1, 3, 67])
@pytest.mark.parametrize("points", [200, 512])
@pytest.mark.parametrize("width", F32_WIDTHS)
def test_pointnet_bwd_f32_widths(card, width, points, objects):
    """The f32 backward over the routed rows against the plain (dense)
    version at any C3 (no padding), P a multiple of 8 or not, 1, 3 or 67
    objects; the same bits twice, and as many 64-row tiles as the routed
    rows fill."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd

    x, ws = _f32_weights(card, objects, points, width, seed=53)
    args = _pointnet_bwd_args(card, x, ws, seed=55)
    card.check_op("pointnet_bwd", args, "f32")
    first, second = pointnet_bwd(*args), pointnet_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _bwd_tiles_match(card, args)


def test_pointnet_fwd_f32_first_index_and_nan(card):
    """The f32 PointNet forward: object 0 repeats point 5 at point 70
    (another tile), object 1 point 9 at point 45 (another row group of the
    same tile), each scaled up so that many channels' max lie on the pair;
    the index must be the first one. Object 2 holds a NaN in x at points
    140 and 20: every channel's max is NaN, at point 20."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd, pointnet_fwd_plain

    x, *ws = card.op_inputs("pointnet_fwd", 3, torch.float32, seed=57, p=200)
    for obj, a, b in ((0, 5, 70), (1, 9, 45)):
        x[obj, :, a] *= 8.0
        x[obj, :, b] = x[obj, :, a]
    x[2, 0, 140] = float("nan")
    x[2, 1, 20] = float("nan")
    out, amax = pointnet_fwd(x, *ws, with_argmax=True)
    want, want_idx = pointnet_fwd_plain(x, *ws, with_argmax=True)
    torch.cuda.synchronize()
    for obj, a, b in ((0, 5, 70), (1, 9, 45)):
        tied = (want_idx[obj] == a) | (want_idx[obj] == b)
        assert bool(tied.float().mean() > 0.2)
        assert bool((amax[obj][tied] == a).all()) and not bool((amax[obj] == b).any())
        torch.testing.assert_close(out[obj], want[obj], rtol=1e-5, atol=1e-5)
    assert bool(out[2].isnan().all()) and bool((amax[2] == 20).all())


def test_pointnet_bwd_f32_ties_dead_and_many_rows(card):
    """The f32 backward (O=8, P=512, C3=200): object 0 repeats point 5 at
    point 70, scaled so that a quarter of its channels tie there (the first
    index routes); object 6's points lie on a sphere, so its maxima scatter
    over more than two 64-row tiles; object 7 is dead (max <= 0). Against
    the plain version, the same bits twice, and the tiles the routing
    fills."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, stack_plain

    x, ws = _f32_weights(card, 8, 512, 200, seed=59)
    x[0, :, 5] *= 30.0
    x[0, :, 70] = x[0, :, 5]
    x[6] = x[6] / x[6].norm(dim=0, keepdim=True) * 2.0
    x[7] *= 0.05
    a3 = stack_plain(x[7:8], *ws[:5], torch.zeros_like(ws[5]))[0]
    ws[5] = -a3[0].amax(dim=0, keepdim=True) - 0.05
    args = _pointnet_bwd_args(card, x, ws, seed=60)
    _, _, amax, peak = args[:4]
    assert not bool((peak[7] > 0).any())
    assert bool(((amax[0] == 5).float().mean() > 0.1)) and not bool((amax[0] == 70).any())
    card.check_op("pointnet_bwd", args, "f32")
    first, second = pointnet_bwd(*args), pointnet_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    live = (peak > 0) & (args[1] != 0)
    routed_6 = len(set(amax[6][live[6]].tolist()))
    assert routed_6 > 128, routed_6
    _bwd_tiles_match(card, args)


def test_pointnet_bwd_f32_nan_point(card):
    """The f32 backward with a NaN in object 1's x at points 7 and 140:
    every channel's max is NaN there and routes nothing, and the weight
    gradients are NaN where the dense plain version's are (its 0·NaN),
    the bias gradients finite and within the tolerance."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_bwd_plain

    x, ws = _f32_weights(card, 3, 200, 200, seed=61)
    x[1, 0, 7] = float("nan")
    x[1, 1, 140] = float("nan")
    args = _pointnet_bwd_args(card, x, ws, seed=62)
    assert bool(args[3][1].isnan().all()) and bool((args[2][1] == 7).all())
    got, want = pointnet_bwd(*args), pointnet_bwd_plain(*args)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.isnan(), w.isnan()), i
        if i % 2:   # the bias gradients
            _, rel = card.compare(g, w)
            assert rel <= card.TOL[("pointnet_bwd", "f32")], (i, rel)
    assert bool(got[4].isnan().all()) and not bool(got[0][2].isnan().any())


def test_pointnet_bwd_f32_routes_by_the_forward_max(card):
    """A channel whose f32 forward max is positive carries its gradient:
    with b3 set so that each channel's maxima straddle 0 over the objects
    and no cotangent near 0, db3 equals Σ_o dout·[peak > 0] of the forward
    kernel's own max (C3 = 200, unpadded)."""
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_pool, stack_plain

    x, ws = _f32_weights(card, 67, 512, 200, seed=63)
    a3 = stack_plain(x, *ws[:5], torch.zeros_like(ws[5]))[0]
    ws[5] = -a3.amax(dim=1).median(dim=0, keepdim=True).values
    peak, amax = pointnet_pool(x, *ws, with_argmax=True)
    pos = (peak > 0).float().mean(dim=0)
    assert bool(((pos > 0) & (pos < 1)).float().mean() > 0.9)
    g = torch.Generator().manual_seed(64)
    mag = 0.5 + torch.rand(67, 200, generator=g)
    sign = torch.where(torch.rand(67, 200, generator=g) < 0.5, -1.0, 1.0)
    dout = (mag * sign).cuda()
    db3 = pointnet_bwd(x, dout, amax, peak, *ws)[5]
    want = (dout.double() * (peak > 0)).sum(dim=0, keepdim=True)
    torch.testing.assert_close(db3.double(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("objects,points", [(3, 200), (1, 5), (67, 512)],
                         ids=["ragged", "fewer_rows_than_the_grid", "main_path"])
def test_pct_epi_sums_stream(card, dtype, objects, points):
    """The streaming epilogue sums against the plain version: row counts
    that are not a multiple of a block's rows per step (600 rows), fewer
    rows than the grid has row lanes (5), and the main path's width; the
    same bits twice."""
    from sgaligner_tpu_torch.ops.pct_attention import epi_sums

    dt_name = "f32" if dtype == torch.float32 else "bf16"
    args = card.op_inputs("pct_epi_sums", objects, dtype, seed=35, p=points)
    card.check_op("pct_epi_sums", args, dt_name)
    first, second = epi_sums(*args), epi_sums(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _held_to_plain_twice(card, name, args, dt_name, flags):
    """One redesigned kernel on ``args``: two launches (counted), its output
    against the plain version's within its tolerance, the same bits twice,
    and each of chip_smoke.py's planted faults of it (KERNEL_PLANTED)
    caught."""
    from sgaligner_tpu_torch.ops import _build

    kern, plain = card.op_fns(name, flags)
    before = _build.LAUNCHES[name]
    got, again = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
    want = card.as_tuple(plain(*args))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    card.judge(name, dt_name, flags, args, got, want, plain)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for what, fault in card.KERNEL_PLANTED[name]:
        with pytest.raises(AssertionError):
            card.judge(name, dt_name, flags, args, fault(got, args), want, plain)


@pytest.mark.parametrize("points", [512, 200, 72, 64])
@pytest.mark.parametrize("objects", [1, 3, 37])
@pytest.mark.parametrize("flags", [SA, OA, (True, True), (False, False)],
                         ids=["SA", "OA", "both", "neither"])
def test_attn_fwd_wgmma(card, flags, objects, points):
    """The bf16 attention forward on the eval block's wgmma passes with the
    attention epilogue, at every (scale, double_norm) pair: at few objects
    (a block with one or no object for one of its warpgroups) and at P a
    multiple of the 64-row tile, ragged, and the main path's. Against the
    plain version, the same bits twice, one 64-row tile of y x1.1 caught."""
    args = card.op_inputs("pct_attn_fwd", objects, torch.bfloat16, seed=41, p=points)
    _held_to_plain_twice(card, "pct_attn_fwd", args, "bf16", flags)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("points", [512, 200, 72, 5])
@pytest.mark.parametrize("objects", [1, 3, 67, 600])
def test_embed_first_bwd_stream(card, objects, points, dtype):
    """The streaming embed_first_bwd at both dtypes: fewer rows than the
    grid has row lanes (O = 1, P = 5), row counts no multiple of a block's
    rows per step, P no multiple of 4 or 8, and the main path's P; the last
    object dead (mask 0: it adds x·dh alone) wherever there are two or
    more. Against the plain version, the same bits twice, a zeroed dW
    caught."""
    x, w, mask, dh, ds1, ds2 = card.op_inputs("embed_first_bwd", objects, dtype, seed=43,
                                              p=points)
    if objects > 1:
        mask[-1] = 0.0
    dt_name = "f32" if dtype == torch.float32 else "bf16"
    _held_to_plain_twice(card, "embed_first_bwd", (x, w, mask, dh, ds1, ds2), dt_name, SA)


# rows of object 0 that repeat its row 5. The bf16 kernel's 64-row tiles:
# the first (9), the second (70, 100) and the third (170). The f32 kernel,
# which pools each row parity in a thread of its own: the same parity in
# its first 128-row tile (9), the other parity (70, 100), merged at the
# object's end, and its second tile (170)
TIED_ROWS = (9, 70, 100, 170)


def _tail_with_ties_and_nans(dtype):
    """Tail inputs (O=5, P=200) whose object 0 repeats row 5 at TIED_ROWS,
    scaled up so that every column's max or min lies on those rows, and
    whose object 2 holds a NaN in rows 7 and 140."""
    import chip_smoke

    x1, x2, x3, x4, w, mask = chip_smoke.op_inputs("pct_tail", 5, torch.float32, seed=3,
                                                   p=200)
    xs = [x1, x2, x3, x4]
    for x in xs:
        x[0, 5] *= 8.0
        for row in TIED_ROWS:
            x[0, row] = x[0, 5]
    x1[2, 7, 3] = float("nan")
    x1[2, 140, 0] = float("nan")
    return [x.to(dtype) for x in xs] + [w.to(dtype), mask.to(dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pct_tail_first_index_and_nan(card, dtype):
    """Ties go to the first row, within a tile and across tiles; a NaN
    beats every number and the first NaN wins; the max / min equal the
    plain version's."""
    from sgaligner_tpu_torch.ops.pct_tail import pct_tail, pct_tail_plain

    args = _tail_with_ties_and_nans(dtype)
    pmax, pmin, _, _, amax, amin = pct_tail(*args, with_index=True)
    want = pct_tail_plain(*args, with_index=True)
    torch.cuda.synchronize()
    # object 0: the repeated row's z is the same bits at row 5 and at
    # TIED_ROWS, and it holds most columns' max or min
    for got, ref in ((amax[0], want[4][0]), (amin[0], want[5][0])):
        tied = (ref == 5) | sum(ref == row for row in TIED_ROWS).bool()
        assert bool(tied.float().mean() > 0.2)
        assert bool((got[tied] == 5).all())
        assert not any(bool((got == row).any()) for row in TIED_ROWS)
    torch.testing.assert_close(pmax[0], want[0][0], rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(pmin[0], want[1][0], rtol=1e-2, atol=1e-2)
    # object 2: every column's max and min are the NaN of row 7
    assert bool(pmax[2].isnan().all()) and bool(pmin[2].isnan().all())
    assert bool((amax[2] == 7).all()) and bool((amin[2] == 7).all())
    # the other objects agree with the plain version
    for i in (1, 3, 4):
        torch.testing.assert_close(pmax[i], want[0][i], rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(pmin[i], want[1][i], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("with_index", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pct_tail_same_bits_twice(card, dtype, with_index):
    """No atomics: the BN sums (and every other output) repeat bit for bit."""
    from sgaligner_tpu_torch.ops.pct_tail import pct_tail

    args = card.op_inputs("pct_tail", 67, dtype, seed=4, p=512)
    first = pct_tail(*args, with_index=with_index)
    second = pct_tail(*args, with_index=with_index)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("points", [200, 512])
@pytest.mark.parametrize("objects", [1, 67])
@pytest.mark.parametrize("name,flags", [("pct_tail", None), ("pct_tail", "idx"),
                                        ("pct_tail_bwd", None)],
                         ids=["pct_tail", "pct_tail_idx", "pct_tail_bwd"])
def test_pct_tail_f32_matches_plain_version(card, name, flags, objects, points):
    """The f32 tail (csrc/tail_f32.cuh's mainloop) at one object (a single
    column of blocks; at P = 200 one full and one ragged 128-row tile) and
    at 67, P a multiple of its 128-row tile and ragged. The backward's dW
    row splits (two blocks a multiprocessor) leave a short last split at
    P = 200 and, at O = 1, empty ones, whose slices must be zero."""
    from sgaligner_tpu_torch.ops import _build

    args = card.op_inputs(name, objects, torch.float32, seed=17, p=points)
    before = _build.LAUNCHES[name]
    card.check_op(name, args, "f32", flags or SA)
    assert _build.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("name,arg", [("pct_tail", 4), ("pct_tail_bwd", 1),
                                      ("pct_tail_bwd", 4), ("pct_tail_bwd", 8),
                                      ("pct_tail_bwd", 10)],
                         ids=["pct_tail-w", "pct_tail_bwd-x2", "pct_tail_bwd-w",
                              "pct_tail_bwd-dsum", "pct_tail_bwd-amax"])
def test_pct_tail_f32_refuses_misaligned_views(card, name, arg):
    """The f32 tail reads W (and in the backward the inputs, the cotangents
    and the indices) 16 bytes at a time: a contiguous view that starts 4
    bytes into its storage raises instead of faulting."""
    from sgaligner_tpu_torch.ops import _build

    args = list(card.op_inputs(name, 3, torch.float32, seed=5, p=200))
    t = args[arg]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    args[arg] = buf[1:].view(t.shape)
    args[arg].copy_(t)
    kern, _ = card.op_fns(name, SA)
    before = _build.LAUNCHES[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        kern(*args)
    assert _build.LAUNCHES[name] == before


# the f32 C = 128 forms of rows 5, 6, 9, 7, 10 and 11 (csrc/attn_f32.cuh's
# passes on tail_f32.cuh's mainloop), SA and OA
NARROW_F32 = [(name, flags) for name in ("pct_block_eval", "pct_block_fwd", "pct_block_res_bwd",
                                         "pct_block_bwd", "pct_attn_fwd", "pct_attn_bwd")
              for flags in (SA, OA)]
NARROW_F32_IDS = [f"{name[4:]}_{'SA' if flags == SA else 'OA'}" for name, flags in NARROW_F32]


@pytest.mark.parametrize("points", [1, 200, 512])
@pytest.mark.parametrize("objects", [1, 3, 67])
@pytest.mark.parametrize("name,flags", NARROW_F32, ids=NARROW_F32_IDS)
def test_attention_f32_c128_matches_plain_version(card, name, flags, objects, points):
    """The f32 C = 128 forms against their plain versions within the f32
    tolerance, one launch a call and the same bits twice, at one object (a
    single tile of a pass, one object a block of the dq pass), 3 and 67,
    and P of one point, ragged (200: one full and one short 128-row tile,
    a last 64-key chunk of 8) and the main path's 512. At P = 200 and 512
    the planted faults of chip_smoke.NARROW_F32_PLANTED (a dx or t_out row
    tile zeroed: the dx and trans passes; dWqk x1.001: the dq pass; dWt
    x1.001: the dz pass; the sums x1.001) must each be caught. At P = 1
    the backwards' dWqk is analytically zero (see below)."""
    from sgaligner_tpu_torch.ops import _build

    args = card.op_inputs(name, objects, torch.float32, seed=23, p=points)
    kern, plain = card.op_fns(name, flags)
    before = _build.LAUNCHES[name]
    got, again = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
    want = card.as_tuple(plain(*args))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if points == 1 and name in ("pct_block_res_bwd", "pct_block_bwd", "pct_attn_bwd"):
        # one key: the softmax is one-hot and dE = G·(dŶ·v − D) is zero, so
        # the plain dWqk is exactly 0 and the kernel's f32 rounding noise:
        # every other output by the usual rule, dWqk against dWv's scale
        rest = [i for i in range(len(got)) if i != 1]
        _, err_rel = card.compare(tuple(got[i] for i in rest), tuple(want[i] for i in rest))
        assert err_rel <= card.tol(name, "f32", flags)
        assert float(got[1].abs().max()) <= 1e-4 * float(want[2].abs().max())
        return
    card.judge(name, "f32", flags, args, got, want, plain)
    if points > 1:
        for what, fault in card.NARROW_F32_PLANTED.get(name, ()):
            with pytest.raises(AssertionError):
                card.judge(name, "f32", flags, args, fault(got, args), want, plain)


@pytest.mark.parametrize("name,flags,arg", [("pct_block_eval", SA, 0), ("pct_block_eval", OA, 1),
                                            ("pct_block_fwd", SA, 4),
                                            ("pct_block_res_bwd", SA, 2),
                                            ("pct_block_bwd", OA, 1), ("pct_attn_fwd", SA, 0),
                                            ("pct_attn_bwd", SA, 4)],
                         ids=["block_eval-x", "block_eval_OA-wqk", "block_fwd-wt",
                              "block_res_bwd-wv", "block_bwd_OA-wqk", "attn_fwd-x",
                              "attn_bwd-dy"])
def test_attention_f32_c128_refuses_misaligned_views(card, name, flags, arg):
    """The f32 C = 128 passes copy x, the weights and the attention op's dy
    16 bytes at a time: a contiguous view that starts 4 bytes into its
    storage raises instead of faulting, with no launch."""
    from sgaligner_tpu_torch.ops import _build

    args = list(card.op_inputs(name, 3, torch.float32, seed=5, p=200))
    t = args[arg]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    args[arg] = buf[1:].view(t.shape)
    args[arg].copy_(t)
    kern, _ = card.op_fns(name, flags)
    before = _build.LAUNCHES[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        kern(*args)
    assert _build.LAUNCHES[name] == before


# the f32 embed_second pair (csrc/embed_f32.cuh's passes on tail_f32.cuh's
# mainloop): (objects, points, masks alternating 0 / 1)
E2_F32_CASES = [(67, 200, True), (67, 72, False), (67, 512, False), (3, 200, False),
                (1, 5, False)]
E2_F32_IDS = ["straddling-alternating", "O67-P72", "O67-P512", "O3-P200", "O1-P5"]


@pytest.mark.parametrize("objects,points,alternate", E2_F32_CASES, ids=E2_F32_IDS)
@pytest.mark.parametrize("name", ["embed_second", "embed_second_bwd"])
def test_embed_second_f32_matches_plain_version(card, name, objects, points, alternate):
    """The f32 embed_second pair against its plain versions within the f32
    tolerance, one launch a call and the same bits twice: at P = 200 with
    object masks alternating 0 / 1 (the 128-row product tiles, two 64-row
    tiles of a slice, straddle objects and every row takes its own
    object's mask), at O = 67 with O·P not a multiple of 128 (a short last
    64-row tile, and slices with an odd count of tiles), at the main path's
    P = 512, and at a few rows (one tile, slices with none). At O = 67 the
    planted faults of chip_smoke.NARROW_F32_PLANTED must each be caught."""
    from sgaligner_tpu_torch.ops import _build

    args = list(card.op_inputs(name, objects, torch.float32, seed=29, p=points))
    if alternate:
        args[4] = (torch.arange(objects, device="cuda") % 2).float().reshape(objects, 1)
    kern, plain = card.op_fns(name)
    before = _build.LAUNCHES[name]
    got, again = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
    want = card.as_tuple(plain(*args))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    card.judge(name, "f32", SA, args, got, want, plain)
    if objects > 3:   # some object masked out, so an unmasked sum shows
        for what, fault in card.NARROW_F32_PLANTED[name]:
            with pytest.raises(AssertionError):
                card.judge(name, "f32", SA, args, fault(got, args), want, plain)


@pytest.mark.parametrize("name,arg", [("embed_second", 0), ("embed_second", 3),
                                      ("embed_second_bwd", 0), ("embed_second_bwd", 5),
                                      ("embed_second_bwd", 6)],
                         ids=["fwd-h0", "fwd-w", "bwd-h0", "bwd-dh", "bwd-ds1"])
def test_embed_second_f32_refuses_misaligned_views(card, name, arg):
    """The f32 embed_second pair copies h0, W1 and dh 16 bytes at a time and
    reads ds1, ds2 as 16-byte vectors: a contiguous view that starts 4
    bytes into its storage raises instead of faulting, with no launch."""
    from sgaligner_tpu_torch.ops import _build

    args = list(card.op_inputs(name, 3, torch.float32, seed=5, p=200))
    t = args[arg]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    args[arg] = buf[1:].view(t.shape)
    args[arg].copy_(t)
    kern, _ = card.op_fns(name)
    before = _build.LAUNCHES[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        kern(*args)
    assert _build.LAUNCHES[name] == before


BWD_CASES = [("pct_block_res_bwd", SA), ("pct_block_res_bwd", OA), ("pct_tail_bwd", None),
             ("pct_block_bwd", SA), ("pct_block_bwd", OA), ("pct_attn_bwd", SA),
             ("pct_attn_bwd", OA), ("embed_second_bwd", None)]
BWD_IDS = ["block_res_bwd_SA", "block_res_bwd_OA", "pct_tail_bwd", "block_bwd_SA",
           "block_bwd_OA", "attn_bwd_SA", "attn_bwd_OA", "embed_second_bwd"]
# the per-object inputs of each backward (the rest are weights and [1, ·]
# vectors) and its per-object outputs (the rest are weight gradients)
BWD_PER_OBJECT = {"pct_block_res_bwd": ((0, 6, 7), 1), "pct_block_bwd": ((0, 6, 7), 1),
                  "pct_attn_bwd": ((0, 4), 1), "pct_tail_bwd": ((0, 1, 2, 3, 5, 6, 7, 10, 11), 4),
                  "embed_second_bwd": ((0, 4, 5), 1)}
# weight gradients of the few objects against the 67-object launch less the
# other 64 objects' launch: f32 sums in other groupings, the difference of
# two sums about 60x larger than it
BWD_BY_DIFFERENCE = 1e-3


@pytest.mark.parametrize("points", [64, 200, 512])
@pytest.mark.parametrize("name,flags", BWD_CASES, ids=BWD_IDS)
def test_wgmma_backwards_match_plain_version(card, name, flags, points):
    """The bf16 backwards' wgmma passes at P a multiple of the 64-row tile,
    ragged, and the main path's, at O = 67 as chip_smoke's kernels phase
    holds them (check_op holds pct_block_res_bwd's dx to the f32 plain
    version, BLOCK_DX_VS_PLAIN)."""
    args = card.op_inputs(name, 67, torch.bfloat16, seed=7, p=points)
    card.check_op(name, args, "bf16", flags or SA)


@pytest.mark.parametrize("points", [64, 200, 512])
@pytest.mark.parametrize("objects", [1, 3])
@pytest.mark.parametrize("name,flags", BWD_CASES, ids=BWD_IDS)
def test_wgmma_backwards_few_objects(card, name, flags, objects, points):
    """At one or three objects (a block whose second warpgroup has no tile,
    a flat row tile past the last row) the bf16 sums run over too few rows
    for the plain version's bound: on an H100 the weight gradients of this
    design and of the earlier one alike read up to 0.23 from it at O = 1.
    So the few objects are held to the 67-object launch that
    test_wgmma_backwards_match_plain_version holds to the plain version:
    their per-object outputs bit for bit, their weight gradients equal to
    the 67 objects' less the other 64 objects' (BWD_BY_DIFFERENCE)."""
    kern, _ = card.op_fns(name, flags or SA)
    big = card.op_inputs(name, 67, torch.bfloat16, seed=7, p=points)
    per_object, n_rows = BWD_PER_OBJECT[name]

    def part(lo, hi):
        return tuple(a[lo:hi].contiguous() if i in per_object else a
                     for i, a in enumerate(big))

    full, few, rest = (card.as_tuple(kern(*args))
                       for args in (big, part(0, objects), part(objects, 67)))
    torch.cuda.synchronize()
    for i in range(n_rows):
        assert torch.equal(few[i], full[i][:objects]), (name, i)
    for a, b, c in zip(few[n_rows:], full[n_rows:], rest[n_rows:]):
        want = b.double() - c.double()
        err = float((a.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))
        assert err <= BWD_BY_DIFFERENCE, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,flags", [("embed_first", SA), ("embed_second", SA),
                                        ("pct_block_res_bwd", SA), ("pct_block_res_bwd", OA),
                                        ("pct_tail_bwd", SA), ("pct_block_fwd", SA),
                                        ("pct_block_fwd", OA), ("pointnet_fwd", SA),
                                        ("embed_second_bwd", SA)],
                         ids=["embed_first", "embed_second", "block_res_bwd_SA",
                              "block_res_bwd_OA", "pct_tail_bwd", "block_fwd_SA",
                              "block_fwd_OA", "pointnet_fwd", "embed_second_bwd"])
def test_same_bits_twice(card, name, flags, dtype):
    """No atomics: every output, the embeddings' BN sums and the PointNet
    forward's argmax included, repeats bit for bit on the same inputs."""
    kern, _ = card.op_fns(name, flags)
    args = card.op_inputs(name, 67, dtype, seed=11)
    first, second = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second)), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["neither", "both"])
def test_block_eval_mixed_flags(card, flags, dtype):
    """pct_block_eval computes the mixed flag pairs (SA's scale with OA's
    normalisation, or neither) on the card, as the JAX op does."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.op_inputs("pct_block_eval", 37, dt, seed=15, p=200)
    card.check_op("pct_block_eval", args, dtype, flags)


# Eval-mode gradients on the card at f32 against the CPU at f64: PCT_VS_CPU
# times the CPU's own f32 distance plus this floor. In eval no one-pass
# BatchNorm moment raises the CPU's own f32 distance (it reads about 1e-6),
# while the card's backward kernels sum O·P products in f32 in long
# sequential chains where the CPU's products sum pairwise: SPCT's
# embedding.conv1.weight, whose gradient cancels across 19k rows, read
# 1.5e-4 on an H100 (NVIDIA H100 80GB HBM3, 700 W). A missing gradient
# (no autograd node) reads 1.0
EVAL_F32_SUMS = 5e-4


@pytest.mark.parametrize("model", ["NaivePCT", "SPCT"])
def test_eval_gradients_on_the_card_match_the_cpu(card, model):
    """An eval-mode encoder with gradients on: the eval ops' autograd
    Functions give every parameter its gradient on the card, held to the
    CPU's at f64 (PCT_VS_CPU times the CPU's own f32 distance, plus
    EVAL_F32_SUMS)."""
    from sgaligner_tpu_torch.engine.factory import init_weights
    from sgaligner_tpu_torch.models import pct

    g = torch.Generator().manual_seed(16)
    o = 37
    pts = torch.randn(o, card.P, 3, generator=g)
    mask = torch.rand(o, generator=g) < 0.85
    runs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        net = getattr(pct, model)(dtype=dtype)
        init_weights(net, torch.Generator().manual_seed(17))
        net = net.to(dev, dtype).eval()
        x = pts.to(dev, dtype)
        if model == "NaivePCT":
            x = x.transpose(1, 2).contiguous()
        outs = card.as_tuple(net(x, mask.to(dev)))
        gc = torch.Generator().manual_seed(18)
        cts = [torch.randn(t.shape, generator=gc).to(dev, dtype) for t in outs]
        names, prms = zip(*net.named_parameters())
        grads = torch.autograd.grad(outs, prms, cts, allow_unused=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev, dtype] = {k: v.double().cpu() for k, v in zip(names, grads) if v is not None}
    ref = runs["cpu", torch.float64]
    assert runs["cuda", torch.float32].keys() == ref.keys()
    for k, v in ref.items():
        if float(v.norm()) == 0.0:
            continue
        dist = {key: float((run[k] - v).norm() / v.norm())
                for key, run in runs.items() if key != ("cpu", torch.float64)}
        bound = card.PCT_VS_CPU * dist["cpu", torch.float32] + EVAL_F32_SUMS
        assert dist["cuda", torch.float32] <= bound, (k, dist)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [200, 100])
def test_pointnet_fwd_at_eva_width(card, width, dtype):
    """The PointNet forward at C3 = 200 (EVA's) and 100: the wrapper pads W3
    and b3 with zero channels to its kernel's width (f32: 208 / 112; bf16:
    256 / 128) and crops the output and the argmax. Held to the plain
    version as at 256 (argmax by value), the same bits twice, and the same
    values without the argmax."""
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.op_inputs("pointnet_fwd", 67, dt, seed=11, c3=width)
    before = _build.LAUNCHES["pointnet_fwd"]
    card.check_op("pointnet_fwd", args, dtype)
    assert _build.LAUNCHES["pointnet_fwd"] == before + 1
    first, second = pointnet_fwd(*args, with_argmax=True), pointnet_fwd(*args, with_argmax=True)
    alone, _ = pointnet_fwd(*args)
    torch.cuda.synchronize()
    assert first[0].shape == first[1].shape == (67, width)
    assert first[0].is_contiguous() and first[1].is_contiguous()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(first[0], alone)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [200, 100])
def test_pointnet_bwd_at_eva_width(card, width, dtype):
    """The PointNet backward at C3 = 200 (EVA's) and 100: the wrapper pads
    W3, b3, dout and peak with zero channels and amax with point 0 to the
    kernels' multiple of 16 (208 / 112), launches once and crops dW3 and
    db3. Held to the plain backward at the width itself, the same bits
    twice, and through the autograd Function (zero x gradient)."""
    from sgaligner_tpu_torch.ops import _build
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_bwd, pointnet_fused

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.op_inputs("pointnet_bwd", 67, dt, seed=12, c3=width)
    before = _build.LAUNCHES["pointnet_bwd"]
    card.check_op("pointnet_bwd", args, dtype)
    assert _build.LAUNCHES["pointnet_bwd"] == before + 1
    first, second = pointnet_bwd(*args), pointnet_bwd(*args)
    torch.cuda.synchronize()
    assert first[4].shape == (128, width) and first[5].shape == (1, width)
    assert first[4].is_contiguous() and first[5].is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    x, _, _, _, *ws = args
    x = x.clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in ws]
    dout = args[1]
    grads = torch.autograd.grad(pointnet_fused(x, *ws), [x, *ws], dout)
    assert not bool(grads[0].any())
    assert all(g.shape == w.shape for g, w in zip(grads[1:], ws))


def test_eva_train_steps_on_the_card_match_the_cpu(card):
    """Three EVA train steps (C3 = 200: both PointNet kernels padded, GCN,
    NCA objective) at f32 from the same seeded weights on one pooled batch,
    card against CPU by the point training rule (PERF.md §2): worst
    gradient leaf of step 1 TRAIN_GRAD_DRIFT normwise, losses
    TRAIN_LOSS_DRIFT relative, parameters' card-CPU distance
    TRAIN_PARAM_DRIFT of the distance moved."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.ops import _build

    modules = ("point", "gcn", "rel", "attr")
    cfg = make_cfg(modules=list(modules), model_name="eva")
    host = pool_compact(make_synthetic_batch(
        BatchSpec(batch_size=8, max_objects=16, points_per_object=512), seed=3,
        bow_noise=1.0, resample=True), 64)
    before = dict(_build.LAUNCHES)
    runs = {dev: card._train_three(cfg, host, dev, modules) for dev in ("cpu", "cuda")}
    for name in card.POINT_KERNELS:
        assert _build.LAUNCHES[name] == before[name] + 3, name
    bounds = {"grad": card.TRAIN_GRAD_DRIFT, "loss": card.TRAIN_LOSS_DRIFT,
              "param": card.TRAIN_PARAM_DRIFT}
    r = card._train_readings(runs["cpu"], runs["cuda"], bounds)
    assert not r["failed"], r
    assert runs["cpu"]["losses"][2]["loss"] < runs["cpu"]["losses"][0]["loss"]


def test_eva_on_the_card_matches_the_cpu(card):
    """EVA (C3 = 200, GCN, NCA objective) at f32 with seeded weights on one
    pooled batch: the card's embeddings and eval-step components against
    the CPU's, relative 1e-4 on the valid rows (card.PARITY_DRIFT is the
    model-level bound; this batch has no max-pool near-ties)."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model, build_objective
    from sgaligner_tpu_torch.engine.train_step import make_eval_step

    cfg = make_cfg(modules=["point", "gcn", "rel", "attr"], model_name="eva")
    batch = pool_compact(make_synthetic_batch(
        BatchSpec(batch_size=4, max_objects=16, points_per_object=512), seed=3,
        bow_noise=0.3), 64)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, torch.Generator().manual_seed(0))
        step = make_eval_step(model, build_objective(cfg).to(dev), tuple(cfg.modules))
        b = to_device(batch, dev)
        with torch.inference_mode():
            outs[dev] = (model(b), step(b))
    mask = torch.as_tensor(batch["obj_mask"]).reshape(-1)
    for k, emb in outs["cpu"][0].items():
        got = outs["cuda"][0][k].cpu()[mask]
        want = emb[mask]
        assert float((got - want).norm() / want.norm()) <= 1e-4, k
    assert abs(float(outs["cuda"][1]["loss"]) - float(outs["cpu"][1]["loss"])) <= 1e-4 * abs(
        float(outs["cpu"][1]["loss"]))


# the kernels at C = 256, da = 64: the block kernels FullPCT's OA blocks
# run, and the two ops' three
WIDE_CASES = [("pct_block_eval", SA), ("pct_block_eval", OA), ("pct_block_fwd", SA),
              ("pct_block_fwd", OA), ("pct_epi_sums", None), ("pct_block_res_bwd", SA),
              ("pct_block_res_bwd", OA), ("pct_block_bwd", SA), ("pct_block_bwd", OA),
              ("pct_attn_fwd", SA), ("pct_attn_fwd", OA), ("pct_attn_bwd", SA),
              ("pct_attn_bwd", OA)]


# (dtype, objects): 37 objects at both dtypes (148 row tiles at P = 256,
# more than an H100's 132 resident blocks); at f32 also few objects (1, 3)
# and 20 (80 row tiles, so some resident blocks get no tile and the
# double-buffered passes see one tile each)
WIDE_SIZES = [("f32", 37), ("bf16", 37), ("f32", 1), ("f32", 3), ("f32", 20)]


@pytest.mark.parametrize("points", [256, 72])
@pytest.mark.parametrize("dtype,objects", WIDE_SIZES,
                         ids=[f"{d}-O{o}" for d, o in WIDE_SIZES])
@pytest.mark.parametrize("name,flags", WIDE_CASES,
                         ids=["block_SA", "block_OA", "block_fwd", "block_fwd_OA", "epi_sums",
                              "block_res_bwd", "block_res_bwd_OA", "block_bwd_SA",
                              "block_bwd_OA", "attn_fwd_SA", "attn_fwd_OA", "attn_bwd_SA",
                              "attn_bwd_OA"])
def test_c256_kernel_matches_plain_version(card, name, flags, dtype, objects, points):
    """The C = 256 forms (csrc/pct_attention_c256.cu, csrc/pct_epi_sums.cu)
    against the plain versions at chip_smoke's tolerances: one launch of the
    C = 256 kernel a call, the same bits twice."""
    from sgaligner_tpu_torch.ops import _build

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.untied(name, card.op_inputs(name, objects, dt, seed=5, p=points,
                                            c=card.WIDE_C), flags or SA)
    wide = name + "_c256"
    before = _build.LAUNCHES[wide]
    card.check_op(name, args, dtype, flags or SA)
    assert _build.LAUNCHES[wide] == before + 1
    kern, _ = card.op_fns(name, flags or SA)
    first, second = card.as_tuple(kern(*args)), card.as_tuple(kern(*args))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_c256_wrappers_raise_where_there_is_no_kernel(card):
    """Every wrapper of the attention family raises on the card at a width
    with no kernel (C = 192: the kernels take 128 and 256), before any
    launch."""
    from sgaligner_tpu_torch.ops import _build, pct_attention

    c = 192
    x, wqk, wv, bv, wt, bt, mask = card.op_inputs("pct_block_fwd", 4, torch.float32, seed=0,
                                                  p=64, c=c)
    vec = torch.ones(c, device="cuda")
    ds = [torch.zeros(1, c, device="cuda") for _ in range(2)]
    calls = {"pct_block_eval": lambda: pct_attention.pct_block_eval(x, wqk, wv, bv, wt, bt,
                                                                    vec, vec),
             "block_fwd": lambda: pct_attention.block_fwd(x, wqk, wv, bv, wt, bt, mask),
             "epi_sums": lambda: pct_attention.epi_sums(x, vec, vec, x),
             "block_res_bwd": lambda: pct_attention.block_res_bwd(x, wqk, wv, bv, wt, bt, mask,
                                                                  x, vec, vec, *ds),
             "block_bwd": lambda: pct_attention.block_bwd(x, wqk, wv, bv, wt, bt, mask, x, *ds),
             "attn_fwd": lambda: pct_attention.attn_fwd(x, wqk, wv, bv),
             "attn_bwd": lambda: pct_attention.attn_bwd(x, wqk, wv, bv, x)}
    before = dict(_build.LAUNCHES)
    for what, call in calls.items():
        with pytest.raises(ValueError):
            call()
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_full_pct_on_the_card_matches_the_cpu(card, train):
    """FullPCT (N = 128 points, samples (64, 32), O = 12) on the card at f32
    against its CPU path at f32 and f64, the same seeded weights, the CPU
    runs replaying the card's FPS and KNN picks (chip_smoke's
    grouping_indices), head dropout off: the output, and in train mode the
    running statistics and every parameter gradient (quiet leaves left out),
    each held to PCT_VS_CPU times the CPU's own f32 distance from f64; four
    launches of the C = 256 block kernel a call."""
    from sgaligner_tpu_torch.engine.factory import build_full_pct
    from sgaligner_tpu_torch.ops import _build

    g = torch.Generator().manual_seed(12)
    pts = torch.randn(12, 128, 3, generator=g)
    mask = torch.rand(12, generator=g) < 0.85
    pts[~mask] = 0.0
    runs, picks = {}, []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        net = build_full_pct("cpu", dtype, seed=13, samples=(64, 32))
        net = net.to(dev, dtype).train(train)
        net.dropout = 0.0
        before = dict(_build.LAUNCHES)
        with card.grouping_indices([] if dev == "cpu" else picks,
                                   picks if dev == "cpu" else None):
            with torch.set_grad_enabled(train):
                out = net(pts.to(dev, dtype), mask.to(dev))
            read = {"output": out.detach()}
            if train:
                ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(14))
                names, prms = zip(*net.named_parameters())
                read.update(zip(names, torch.autograd.grad(out, prms, ct.to(dev, dtype))))
                read.update((k, v) for k, v in net.state_dict().items() if "running_" in k)
        if dev == "cuda":
            torch.cuda.synchronize()
            blocks = "pct_block_fwd_c256" if train else "pct_block_eval_c256"
            assert _build.LAUNCHES[blocks] == before[blocks] + 4
        runs[dev, dtype] = {k: v.double().cpu() for k, v in read.items()}
    ref = runs["cpu", torch.float64]
    quiet = card.quiet_leaves({k: v for k, v in ref.items() if "." in k
                               and "running_" not in k}) if train else set()
    for k, v in ref.items():
        if k in quiet:
            continue
        dist = {key: float((run[k] - v).norm() / v.norm().clamp_min(1e-30))
                for key, run in runs.items() if key != ("cpu", torch.float64)}
        assert dist["cuda", torch.float32] <= card.PCT_VS_CPU * dist["cpu", torch.float32] + 1e-6, \
            (k, dist)
