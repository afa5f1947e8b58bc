#!/usr/bin/env python3
"""The bf16 forwards of the pct block (eval and training), the attention
op, embed_second and the PointNet encoder, and the f32 PointNet forward, on
one NVIDIA GPU: times at the training and serving O.

    python3 scripts/chip_fwd_check.py [label] [--f32-pointnet]

Run from a checkout's root (it imports that checkout's chip_smoke.py and
sgaligner_tpu_torch); running it from two checkouts on one card compares
two designs on the same seeded inputs. Prints, per line and prefixed by
``label``:

* the compiler's registers and spills of the forward kernels (the build's
  ptxas notes);
* pct_block_fwd, pct_block_eval and pct_attn_fwd (SA, OA) at O = 896,
  embed_second and pointnet_fwd (with the argmax) at O = 896, and those
  three at the serving O = 13,440 (P = 512):
  CUDA-event ms (median of 9), the bound from chip_smoke.bound, the error
  against the plain version (at O = 896), and the device ms of each kernel
  under torch.profiler;
* the f32 PointNet forward (the EVA recipe's form, any C3) with the
  argmax at O = 256 and 896, C3 = 200 and 256: the same readings;
* the point configuration's four B = 512 requests, as chip_smoke.py's
  serve_point phase serves them (after its serve phase, which makes the
  requests), with their host-clock times.
With --f32-pointnet only the ptxas notes and the f32 PointNet lines.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# kernel names of both designs' passes (the wgmma design's, then the
# shared-memory WMMA design's), matched after the namespace
PASSES = ("project_wgmma_kernel", "lse_wgmma_kernel", "apply_wgmma_kernel",
          "embed_second_wgmma_kernel", "project_kernel", "lse_kernel", "apply_kernel",
          "attn_out_kernel", "embed_second_kernel", "pointnet_fwd_wgmma_kernel",
          "pointnet_fwd_kernel", "pointnet_fwd_f32_kernel", "reduce_slices_kernel")


def registers(tag: str) -> None:
    from sgaligner_tpu_torch.ops import _build

    _build.lib()
    lines = (Path(_build.build_info["path"]).parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in ("apply_wgmma", "attn_out",
                                                                 "embed_second", "pointnet_fwd")):
            name = line.split("'")[1]
            notes = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                               if "Used" in x or "spill" in x)
            print(f"{tag} ptxas {name}: {notes}", flush=True)


def times(tag: str) -> None:
    for name, flags, o in (("pct_block_fwd", cs.SA, 896), ("pct_block_fwd", cs.OA, 896),
                           ("pct_block_eval", cs.SA, 896), ("pct_block_eval", cs.OA, 896),
                           ("pct_attn_fwd", cs.SA, 896), ("pct_attn_fwd", cs.OA, 896),
                           ("embed_second", cs.SA, 896), ("pointnet_fwd", cs.SA, 896),
                           ("embed_second", cs.SA, 13440), ("pct_block_eval", cs.SA, 13440),
                           ("pointnet_fwd", cs.SA, 13440)):
        args = cs.op_inputs(name, o, torch.bfloat16, seed=2)
        kern, _ = cs.op_fns(name, flags)
        err = cs.check_op(name, args, "bf16", flags, what=name)[1] if o <= 896 else float("nan")
        ms = cs.cuda_ms(lambda: kern(*args), warmup=3, reps=9)
        b_ms, _ = cs.bound(name, o, oa=flags == cs.OA)
        split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in PASSES))
        print(f"{tag} {name}{'/OA' if flags == cs.OA else ''} O={o}: {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_ms / ms:.1%}), max_rel {err:.2e} | passes " + ", ".join(
                  f"{k[2:]} {v:.3f}" for k, v in split.items()) + f" | {cs.card_line()}",
              flush=True)
        del args
        torch.cuda.empty_cache()


def f32_pointnet(tag: str) -> None:
    kern, _ = cs.op_fns("pointnet_fwd")
    for o in (cs.EVA_TRAIN_O, 896):
        for c3 in (cs.EVA_C3, cs.PN[-1]):
            args = cs.op_inputs("pointnet_fwd", o, torch.float32, seed=2, c3=c3)
            err = cs.check_op("pointnet_fwd", args, "f32", what="pointnet_fwd f32")[1]
            ms = cs.cuda_ms(lambda: kern(*args), warmup=3, reps=9)
            b_ms, _ = cs.bound("pointnet_fwd", o, c3=c3, f32=True)
            split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in PASSES))
            print(f"{tag} pointnet_fwd f32 C3={c3} O={o}: {ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({b_ms / ms:.1%}), max_rel {err:.2e} | passes " + ", ".join(
                      f"{k[2:]} {v:.4f}" for k, v in split.items()) + f" | {cs.card_line()}",
                  flush=True)
            del args
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = args[0] if args else "this"
    registers(tag)
    if "--f32-pointnet" in sys.argv:
        f32_pointnet(tag)
        return 0
    times(tag)
    f32_pointnet(tag)
    print(f"{tag} serve_point:", flush=True)
    state: dict = {}
    for phase in (cs.phase_device, cs.phase_serve, cs.phase_serve_point):
        phase(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
