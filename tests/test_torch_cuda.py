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
                                                        pointnet_fwd_plain)

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
        amax = pointnet_fwd_plain(x, *ws, with_argmax=True)[1]
        want = pointnet_bwd_plain(x, dout, amax, *ws)
        _, rel = card.compare(tuple(grads[1:]), want)
        assert rel <= card.TOL[("pointnet_bwd", "f32")]
        first = pointnet_bwd(x, dout, amax, *ws)
        second = pointnet_bwd(x, dout, amax, *ws)
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
    from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd

    x, *ws = card.op_inputs("pointnet_fwd", 8, torch.float32, seed=0)
    with pytest.raises(ValueError):                  # C3 not a multiple of 16
        pointnet_fwd(x, *ws[:4], ws[4][:, :100].contiguous(),
                     ws[5][:, :100].contiguous())
    with pytest.raises(ValueError):                  # weights on the CPU
        pointnet_fwd(x, *(w.cpu() for w in ws))
