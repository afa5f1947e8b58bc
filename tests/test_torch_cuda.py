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

CASES = [("embed_first", None), ("embed_second", None),
         ("pct_block_eval", (True, False)), ("pct_block_eval", (False, True)),
         ("pct_tail", None), ("pointnet_fwd", None), ("pointnet_bwd", None)]


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
                              "block_OA", "pct_tail", "pointnet_fwd",
                              "pointnet_bwd"])
def test_kernel_matches_plain_version(card, name, flags, dtype, points):
    """check_op raises past the tolerance (and, for the PointNet forward,
    when its argmax points off the max)."""
    from sgaligner_tpu_torch.ops import _build

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = card.op_inputs(name, 37, dt, seed=5, p=points)
    before = _build.LAUNCHES[name]
    card.check_op(name, args, dtype, flags or (True, False))
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
