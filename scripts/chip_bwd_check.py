#!/usr/bin/env python3
"""The bf16 backwards (block, tail, embedding, PointNet), the epilogue sums
and the f32 PointNet backward on one NVIDIA GPU: accuracy at few objects,
and times at the training O.

    python3 scripts/chip_bwd_check.py [label] [--times-only] [--f32-pointnet] [--wide-only]
    python3 scripts/chip_bwd_check.py [label] --dx-rule

Run from a checkout's root (it imports that checkout's chip_smoke.py and
sgaligner_tpu_torch); running it from two checkouts on one card compares
two designs on the same seeded inputs. Prints, per line and prefixed by
``label``:

* the compiler's registers and spills of the backward kernels (the build's
  ptxas notes);
* unless --times-only: pct_block_res_bwd (SA, OA) at O in {1, 3, 37, 67}
  and P in {64, 200, 512}, two seeds: the normwise distance of the kernel's dx and weight
  gradients from the plain version at f32 on the same bf16 inputs, beside
  the bf16 plain version's own distance (chip_smoke.py's BLOCK_DX_VS_PLAIN
  rule reads their ratio);
* the bf16 backwards (embed_second_bwd, pointnet_bwd and embed_first_bwd
  too) and pct_epi_sums at O = 896 (P = 512): CUDA-event ms (median of 5), the
  bound from chip_smoke.bound (pointnet_bwd's from the work its inputs
  route, chip_smoke.bwd_work), the error against the plain version, and
  the device ms of each kernel under torch.profiler;
* the f32 PointNet backward (the EVA recipe's form, any C3) at O = 256 and
  896, C3 = 200 and 256: the same readings, its four passes' device ms
  among them. With --f32-pointnet only these lines (and the ptxas notes);
* the bf16 backwards at C = 256 (pct_block_res_bwd, pct_block_bwd,
  pct_attn_bwd, SA and OA) at FullPCT's O = 256, P = 256: the same
  readings (each output's distance from the bf16 plain version), and
  unless --times-only pct_block_res_bwd's dx distance rule at C = 256
  for O in {1, 3, 20} at P in {72, 250}, and O = 37 at P = 256. With
  --wide-only only these lines (and the ptxas notes);
* with --dx-rule instead, that rule on the card test's inputs (dx_rule).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def registers(tag: str) -> None:
    from sgaligner_tpu_torch.ops import _build

    _build.lib()
    lines = (Path(_build.build_info["path"]).parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in ("bwd", "wgrad", "_dz_",
                                                                  "epi_sums", "dw3",
                                                                  "pointnet_reduce", "256",
                                                                  "transpose_w3")):
            name = line.split("'")[1]
            notes = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                               if "Used" in x or "spill" in x)
            print(f"{tag} ptxas {name}: {notes}", flush=True)


def accuracy(tag: str) -> None:
    for name, flags in (("pct_block_res_bwd", cs.SA), ("pct_block_res_bwd", cs.OA)):
        for o, p in ((1, 64), (1, 200), (3, 64), (3, 200), (3, 512), (37, 512), (67, 200),
                     (67, 512)):
            for seed in (7, 8):
                args = cs.op_inputs(name, o, torch.bfloat16, seed=seed, p=p)
                kern, plain = cs.op_fns(name, flags)
                got, want = kern(*args), plain(*args)
                ref = plain(*(a.float() for a in args))
                kd, pd = cs.compare(got[0], ref[0])[1], cs.compare(want[0], ref[0])[1]
                wk = " ".join(f"{cs.compare(g, r)[1]:.1e}" for g, r in zip(got[1:], ref[1:]))
                wp = " ".join(f"{cs.compare(g, r)[1]:.1e}" for g, r in zip(want[1:], ref[1:]))
                print(f"{tag} {name} {'OA' if flags == cs.OA else 'SA'} O={o} P={p} seed={seed}: "
                      f"dx from f32 plain: kernel {kd:.3e}, bf16 plain {pd:.3e} (ratio "
                      f"{kd / pd:.2f}) | weight gradients from f32 plain: kernel {wk}; bf16 "
                      f"plain {wp}", flush=True)


# kernel names of both designs' passes (this design's, then the shared-memory
# WMMA design's that it replaced), matched after the namespace
PASSES = ("project_wgmma_kernel", "lse_wgmma_kernel", "dz_wgmma_kernel", "dv_wgmma_kernel",
          "dq_wgmma_kernel", "dx_wgmma_kernel", "wgrad_wgmma_kernel", "transpose_w_kernel",
          "tail_g_wgmma_kernel", "tail_dx_wgmma_kernel", "project_kernel", "lse_kernel",
          "bwd_dz_kernel", "bwd_dv_kernel", "bwd_dq_kernel", "bwd_dx_kernel", "attn_sc_kernel",
          "tail_g_kernel", "tail_dx_kernel", "tail_dw_kernel", "embed_second_bwd_wgmma_kernel",
          "embed_second_bwd_kernel", "pointnet_bwd_wgmma_kernel", "pointnet_dw3_wgmma_kernel",
          "pointnet_bwd_kernel", "epi_sums_stream_kernel", "epi_sums_kernel",
          "embed_first_bwd_stream_kernel", "embed_first_bwd_kernel", "reduce_slices_kernel",
          "transpose_w3_kernel", "pointnet_bwd_f32_kernel", "pointnet_dw3_f32_kernel",
          "pointnet_reduce_f32_kernel")


# the C = 256 forms' passes: the wgmma design's, then the shared-memory WMMA
# design's (csrc/pct_attention_c256.cu) that it replaced
WIDE_PASSES = ("project256_wgmma_kernel", "lse256_wgmma_kernel", "dz256_wgmma_kernel",
               "dv256_wgmma_kernel", "dq256_wgmma_kernel", "dx256_wgmma_kernel",
               "wgrad_wgmma_kernel", "project_kernel", "lse_kernel", "attn_sc_kernel",
               "bwd_dz_kernel", "bwd_dv_kernel", "bwd_dq_kernel", "bwd_dx_kernel",
               "reduce_slices_kernel")


def wide(tag: str, accuracy_too: bool) -> None:
    o, p, c = cs.WIDE_O, cs.WIDE_P, cs.WIDE_C
    name = "pct_block_res_bwd"
    for flags in (cs.SA, cs.OA) if accuracy_too else ():
        for o_small, p_small in ((1, 72), (1, 250), (3, 72), (3, 250), (20, 72), (20, 250),
                                 (37, 256)):
            args = cs.untied(name, cs.op_inputs(name, o_small, torch.bfloat16, seed=7,
                                                p=p_small, c=c), flags)
            kern, plain = cs.op_fns(name, flags)
            got, want = kern(*args), plain(*args)
            ref = plain(*(a.float() for a in args))
            kd, pd = cs.compare(got[0], ref[0])[1], cs.compare(want[0], ref[0])[1]
            wk = " ".join(f"{cs.compare(g, r)[1]:.1e}" for g, r in zip(got[1:], ref[1:]))
            print(f"{tag} {name}_c256 {'OA' if flags == cs.OA else 'SA'} O={o_small} "
                  f"P={p_small}: dx from f32 plain: kernel {kd:.3e}, bf16 plain {pd:.3e} "
                  f"(ratio {kd / pd:.2f}) | weight gradients from f32 plain: kernel {wk}",
                  flush=True)
    for name in ("pct_block_res_bwd", "pct_block_bwd", "pct_attn_bwd"):
        for flags in (cs.SA, cs.OA):
            args = cs.untied(name, cs.op_inputs(name, o, torch.bfloat16, seed=2, p=p, c=c),
                             flags)
            kern, plain = cs.op_fns(name, flags)
            ms = cs.cuda_ms(lambda: kern(*args))
            b_ms, _ = cs.bound(name, o, p, oa=flags == cs.OA, c=c)
            # each output against the bf16 plain version (a reading: the
            # accuracy rules are chip_smoke.py's and the card tests')
            err = " ".join(f"{cs.compare(g, w)[1]:.1e}"
                           for g, w in zip(kern(*args), plain(*args)))
            split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in WIDE_PASSES))
            print(f"{tag} {name}_c256{'/OA' if flags == cs.OA else ''} O={o} P={p}: {ms:.3f} "
                  f"ms, bound {b_ms:.4f} ms, max_rel {err} | passes " + ", ".join(
                      f"{k[2:]} {v:.4f}" for k, v in split.items()) + f" | {cs.card_line()}",
                  flush=True)
            del args
            torch.cuda.empty_cache()


def dx_rule(tag: str) -> None:
    """pct_block_res_bwd's bf16 dx rule at C = 256 on the card test's
    inputs (seed 5) at few objects and ragged P: the kernel's and the bf16
    plain version's dx distance from the f32 plain version, with dxn zeroed
    where the relu input lies within 1e-5 (chip_smoke.untied's band) or 1e-2
    of 0 relative to its largest value, and where the kernel's worst element
    sits; pct_block_bwd's dx (no relu routing) beside it."""
    from sgaligner_tpu_torch.ops.pct_attention import block_math

    name = "pct_block_res_bwd"
    for flags, fl in ((cs.SA, "SA"), (cs.OA, "OA")):
        for o, p in ((1, 72), (1, 250), (3, 72), (3, 250), (20, 72), (20, 250), (37, 256),
                     (37, 72)):
            raw = cs.op_inputs(name, o, torch.bfloat16, seed=5, p=p, c=cs.WIDE_C)
            x, wqk, wv, bv, wt, bt, mask, dxn, wbn, bbn, *rest = raw
            t = block_math(*(a.double() for a in (x, wqk, wv, bv, wt, bt)), *flags)
            z = t * wbn.double() + bbn.double()
            kern, plain = cs.op_fns(name, flags)
            for band in (1e-5, 1e-2):
                tie = z.abs() < band * z.abs().max()
                args = (x, wqk, wv, bv, wt, bt, mask, dxn.masked_fill(tie, 0), wbn, bbn, *rest)
                got, want = kern(*args), plain(*args)
                ref = plain(*(a.float() for a in args))
                kd, pd = cs.compare(got[0], ref[0])[1], cs.compare(want[0], ref[0])[1]
                at = int((got[0].double() - ref[0].double()).abs().argmax())
                ob, row = at // (p * cs.WIDE_C), at // cs.WIDE_C % p
                print(f"{tag} {name}_c256 {fl} O={o} P={p} band={band:g}: dx from f32 plain: "
                      f"kernel {kd:.3e}, bf16 plain {pd:.3e} (ratio {kd / pd:.2f}), the "
                      f"kernel's worst at object {ob} row {row}", flush=True)
            argsb = cs.op_inputs("pct_block_bwd", o, torch.bfloat16, seed=5, p=p, c=cs.WIDE_C)
            kb, pb = cs.op_fns("pct_block_bwd", flags)
            rb = pb(*(a.float() for a in argsb))[0]
            print(f"{tag} pct_block_bwd_c256 {fl} O={o} P={p}: dx from f32 plain: kernel "
                  f"{cs.compare(kb(*argsb)[0], rb)[1]:.3e}, bf16 plain "
                  f"{cs.compare(pb(*argsb)[0], rb)[1]:.3e}", flush=True)


def times(tag: str) -> None:
    o = 896
    for name, flags in (("pct_block_res_bwd", cs.SA), ("pct_block_res_bwd", cs.OA),
                        ("pct_tail_bwd", None), ("pct_block_bwd", cs.SA),
                        ("pct_block_bwd", cs.OA), ("pct_attn_bwd", cs.SA),
                        ("pct_attn_bwd", cs.OA), ("embed_second_bwd", None),
                        ("pointnet_bwd", None), ("pct_epi_sums", None),
                        ("embed_first_bwd", None)):
        args = cs.op_inputs(name, o, torch.bfloat16, seed=2)
        kern, _ = cs.op_fns(name, flags or cs.SA)
        ms = cs.cuda_ms(lambda: kern(*args))
        work = cs.bwd_work(args) if name == "pointnet_bwd" else None
        b_ms, _ = cs.bound(name, o, oa=flags == cs.OA, work=work)
        err = cs.check_op(name, args, "bf16", flags or cs.SA, what=name)[1]
        split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in PASSES))
        print(f"{tag} {name}{'/OA' if flags == cs.OA else ''} O={o}: {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms, max_rel {err:.2e} | passes " + ", ".join(
                  f"{k[2:]} {v:.3f}" for k, v in split.items()) + f" | {cs.card_line()}",
              flush=True)
        del args
        torch.cuda.empty_cache()


def f32_pointnet(tag: str) -> None:
    kern, _ = cs.op_fns("pointnet_bwd")
    for o in (cs.EVA_TRAIN_O, 896):
        for c3 in (cs.EVA_C3, cs.PN[-1]):
            args = cs.op_inputs("pointnet_bwd", o, torch.float32, seed=2, c3=c3)
            ms = cs.cuda_ms(lambda: kern(*args))
            work = cs.bwd_work(args)
            b_ms, _ = cs.bound("pointnet_bwd", o, work=work, c3=c3, f32=True)
            err = cs.check_op("pointnet_bwd", args, "f32", what="pointnet_bwd f32")[1]
            split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in PASSES))
            print(f"{tag} pointnet_bwd f32 C3={c3} O={o}: {ms:.3f} ms, bound {b_ms:.4f} ms, "
                  f"max_rel {err:.2e}, {work[0]} rows / {work[1]} channels carry gradient | "
                  "passes " + ", ".join(f"{k[2:]} {v:.4f}" for k, v in split.items())
                  + f" | {cs.card_line()}", flush=True)
            del args
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = args[0] if args else "this"
    registers(tag)
    if "--dx-rule" in sys.argv:
        dx_rule(tag)
        return 0
    if "--wide-only" in sys.argv:
        wide(tag, "--times-only" not in sys.argv)
        return 0
    if "--f32-pointnet" not in sys.argv:
        if "--times-only" not in sys.argv:
            accuracy(tag)
        times(tag)
        wide(tag, "--times-only" not in sys.argv)
    f32_pointnet(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
