#!/usr/bin/env python3
"""The bf16 block, tail and embedding backwards on one NVIDIA GPU: accuracy
at few objects, and times at the training O.

    python3 scripts/chip_bwd_check.py [label]

Run from a checkout's root (it imports that checkout's chip_smoke.py and
sgaligner_tpu_torch); running it from two checkouts on one card compares
two designs on the same seeded inputs. Prints, per line and prefixed by
``label``:

* the compiler's registers and spills of the backward kernels (the build's
  ptxas notes);
* pct_block_res_bwd (SA, OA) at O in {1, 3, 37, 67} and P in {64, 200,
  512}, two seeds: the normwise distance of the kernel's dx and weight
  gradients from the plain version at f32 on the same bf16 inputs, beside
  the bf16 plain version's own distance (chip_smoke.py's BLOCK_DX_VS_PLAIN
  rule reads their ratio);
* the bf16 backwards (embed_second_bwd too) at O = 896 (P = 512):
  CUDA-event ms (median of 5), the
  bound from chip_smoke.bound, the error against the plain version, and
  the device ms of each kernel under torch.profiler.
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
        if "Compiling entry" in line and ("bwd" in line or "wgrad" in line or "_dz_" in line):
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
                kd, pd = cs.compare(got[0], ref)[1], cs.compare(want[0], ref)[1]
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
          "embed_second_bwd_kernel", "reduce_slices_kernel")


def times(tag: str) -> None:
    o = 896
    for name, flags in (("pct_block_res_bwd", cs.SA), ("pct_block_res_bwd", cs.OA),
                        ("pct_tail_bwd", None), ("pct_block_bwd", cs.SA),
                        ("pct_block_bwd", cs.OA), ("pct_attn_bwd", cs.SA),
                        ("pct_attn_bwd", cs.OA), ("embed_second_bwd", None)):
        args = cs.op_inputs(name, o, torch.bfloat16, seed=2)
        kern, _ = cs.op_fns(name, flags or cs.SA)
        ms = cs.cuda_ms(lambda: kern(*args))
        b_ms, _ = cs.bound(name, o, oa=flags == cs.OA)
        err = cs.check_op(name, args, "bf16", flags or cs.SA, what=name)[1]
        split = cs.pass_split(lambda: kern(*args), tuple(f"::{k}" for k in PASSES))
        print(f"{tag} {name}{'/OA' if flags == cs.OA else ''} O={o}: {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms, max_rel {err:.2e} | passes " + ", ".join(
                  f"{k[2:]} {v:.3f}" for k, v in split.items()) + f" | {cs.card_line()}",
              flush=True)
        del args
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = sys.argv[1] if len(sys.argv) > 1 else "this"
    registers(tag)
    accuracy(tag)
    times(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
