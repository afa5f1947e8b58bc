#!/usr/bin/env python3
"""The f32 kernels that run on the port's CUDA-core products (block_gemm:
the C = 256 block kernels of csrc/pct_attention_c256.cu and the f32 forms of
csrc/pct_attention.cu and csrc/pct_embed.cu; tail_f32.cuh: the f32 tail of
csrc/pct_tail.cu) on one NVIDIA GPU: times, pass split, and their outputs
for a bit-for-bit comparison of two checkouts; with --step, the f32 pct
train step.

    python3 scripts/chip_f32_check.py [label] [--times-only | --bits-only | --narrow-only]
    python3 scripts/chip_f32_check.py [label] --step
    python3 scripts/chip_f32_check.py --compare DIR_A DIR_B

Run from a checkout's root (it imports that checkout's chip_smoke.py and
sgaligner_tpu_torch); running it from two checkouts on one card compares
two designs on the same seeded inputs. Prints, per line and prefixed by
``label``:

* the compiler's registers and spills of the f32 C = 256 kernels, of the
  f32 C = 128 passes, and of every kernel that spills (the build's ptxas
  notes);
* rows 5, 6 and 9 at C = 256 (pct_block_eval, pct_block_fwd,
  pct_block_res_bwd; OA, FullPCT's O = 256, P = 256, f32): CUDA-event ms
  (median of 9), the plain version's ms, the bound at the f32 rate from
  chip_smoke.bound, and the device ms of each pass under torch.profiler
  (a fresh process, so the profiler counts every launch);
* rows 5, 6, 7, 9, 10 and 11 at C = 128 (f32, O = 896, P = 512, SA and
  OA): CUDA-event ms (median of 5), the plain version's ms, the bound at the
  f32 rate, and the device ms of each pass under torch.profiler (C128_PASSES:
  the first versions' pass kernels and the redesign's, whichever the
  checkout has);
* every f32 form chip_smoke.time_f32_forms times (the block kernels and
  the tail pair) at O = 896, P = 512: kernel ms, plain ms and bound;
* unless --times-only: the outputs of every f32 kernel on the inputs of
  chip_smoke.py's kernels phase (O = 67; P = 512 and 200 at C = 128, P =
  256 and 200 at C = 256, both flag sets) saved under build/f32_bits/<label>/
  (gitignored). ``--compare DIR_A DIR_B`` (two such folders) then says,
  output by output, whether the two checkouts gave the same bits, and the
  largest difference where not.

``--step`` runs instead bench.py's pct training step at compute_dtype
float32 (B = 32, O = 896; chip_smoke._bench_train with F32_STEP's windows
and a torch.profiler pass for the device time) on the checkout it is run
from, with the _bench_train of the chip_smoke.py beside this script, so
two checkouts are timed by the same code.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the C = 256 passes (the same kernel names as the C = 128 file's, which no
# call of this script runs in the same window)
C256_PASSES = ("::project_kernel", "::lse_kernel", "::apply_kernel", "::bwd_dz_kernel",
               "::bwd_dv_kernel", "::bwd_dq_kernel", "::bwd_dx_kernel",
               "::reduce_slices_kernel")
# the C = 128 forms' passes: the first versions' (block_gemm) and the
# redesign's (tail_f32.cuh's mainloop); a checkout shows the ones it has
C128_PASSES = ("::project_kernel", "::lse_kernel", "::apply_kernel", "::attn_out_kernel",
               "::attn_sc_kernel", "::bwd_dz_kernel", "::bwd_dv_kernel", "::bwd_dq_kernel",
               "::bwd_dx_kernel", "::proj_kernel", "::lse128_kernel", "::attend_kernel",
               "::trans_kernel", "::dy_kernel",
               "::sc_kernel", "::dv_kernel", "::dd_kernel", "::dq_kernel", "::dx_kernel",
               "::wgrad_kernel", "::colsum_kernel", "::reduce_slices_kernel",
               # the f32 embed_second pair: the first versions' and the redesign's
               "::embed_second_kernel", "::embed_second_bwd_kernel",
               "::embed_second_f32_kernel", "::transpose128_kernel",
               "::embed_second_dz_kernel", "::embed_second_wgrad_kernel")
NARROW = ("pct_block_eval", "pct_block_fwd", "pct_block_res_bwd", "pct_block_bwd",
          "pct_attn_fwd", "pct_attn_bwd")
E2 = ("embed_second", "embed_second_bwd")
BITS = Path("build") / "f32_bits"
WIDE_O = cs.FULL_PCT_PAIRS * 2 * cs.FULL_PCT_SLOTS


def registers(tag: str) -> None:
    from sgaligner_tpu_torch.ops import _build

    _build.lib()
    lines = (Path(_build.build_info["path"]).parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" not in line:
            continue
        notes = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                 if "Used" in x or "spill" in x]
        spills = any("spill" in x and "0 bytes spill stores, 0 bytes spill loads" not in x
                     for x in notes)
        # the f32 C = 256 kernels, the f32 C = 128 passes (namespace f32) and
        # the embed_second pair's
        if (spills or ("c256" in line and "kernelIf" in line) or "3f32" in line
                or "embed_second" in line):
            print(f"{tag} ptxas {line.split(chr(39))[1]}: {' | '.join(notes)}", flush=True)


def wide_times(tag: str) -> None:
    for name in ("pct_block_eval", "pct_block_fwd", "pct_block_res_bwd"):
        kern, plain = cs.op_fns(name, cs.OA)
        args = cs.untied(name, cs.op_inputs(name, WIDE_O, torch.float32, seed=2,
                                            p=cs.WIDE_P, c=cs.WIDE_C), cs.OA)
        err = cs.check_op(name, args, "f32", cs.OA, what=name)[1]
        ms = cs.cuda_ms(lambda: kern(*args), warmup=3, reps=9)
        plain_ms = cs.cuda_ms(lambda: plain(*args), warmup=2, reps=5)
        b_ms, _ = cs.bound(name, WIDE_O, cs.WIDE_P, oa=True, f32=True, c=cs.WIDE_C)
        split = cs.pass_split(lambda: kern(*args), C256_PASSES)
        print(f"{tag} {name}_c256/OA/f32 O={WIDE_O} P={cs.WIDE_P}: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_ms / ms:.1%}), max_rel {err:.2e} | "
              "passes " + ", ".join(f"{k[2:]} {v:.3f}" for k, v in split.items())
              + f" | {cs.card_line()}", flush=True)
        del args
        torch.cuda.empty_cache()


def narrow_times(tag: str) -> None:
    o = 896
    forms = [(name, f"/{t}", flags) for name in NARROW for t, flags in (("SA", cs.SA),
                                                                       ("OA", cs.OA))]
    for name, flag_tag, flags in forms + [(name, "", cs.SA) for name in E2]:
        kern, plain = cs.op_fns(name, flags)
        args = cs.op_inputs(name, o, torch.float32, seed=2)
        ms = cs.cuda_ms(lambda: kern(*args), warmup=2, reps=5)
        plain_ms = cs.cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        b_ms, _ = cs.bound(name, o, oa=flags == cs.OA, f32=True)
        split = cs.pass_split(lambda: kern(*args), C128_PASSES)
        print(f"{tag} {name}{flag_tag}/f32 O={o} P={cs.P}: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_ms / ms:.1%}) | passes "
              + ", ".join(f"{k[2:]} {v:.3f}" for k, v in split.items())
              + f" (sum {sum(split.values()):.3f}) | {cs.card_line()}", flush=True)
        del args
        torch.cuda.empty_cache()


def first_versions():
    """(name, tag, flags) of the f32 forms chip_smoke.time_f32_forms times:
    every kernel but the PointNet pair, pct_epi_sums and embed_first_bwd."""
    for name in cs.KERNELS:
        if name in (*cs.POINT_KERNELS, "pct_epi_sums", "embed_first_bwd"):
            continue
        yield from ([(name, "SA", cs.SA), (name, "OA", cs.OA)] if name in cs.ATTN_FNS else
                    [(name, "", cs.SA), (name, "idx", "idx")] if name == "pct_tail"
                    else [(name, "", cs.SA)])


def f32_forms(tag: str) -> None:
    o = 896
    for name, tag2, flags in first_versions():
        kern, plain = cs.op_fns(name, flags)
        args = cs.op_inputs(name, o, torch.float32, seed=2)
        ms = cs.cuda_ms(lambda: kern(*args), warmup=1, reps=5)
        plain_ms = cs.cuda_ms(lambda: plain(*args), warmup=1, reps=3)
        b_ms, _ = cs.bound(name, o, oa=flags == cs.OA, f32=True)
        print(f"{tag} f32 form {name}{'/' + tag2 if tag2 else ''} O={o}: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms | {cs.card_line()}", flush=True)
        del args
        torch.cuda.empty_cache()


def bit_cases():
    """(label, name, flags, args) of every f32 kernel call of the kernels
    phase."""
    for p in (cs.P, cs.RAGGED_P):
        for name in cs.KERNELS:
            variants = ([("SA", cs.SA), ("OA", cs.OA)] if name in cs.ATTN_FNS else
                        [("", cs.SA), ("idx", "idx")] if name == "pct_tail" else [("", cs.SA)])
            if name == "pct_block_eval":
                variants += cs.MIXED_FLAGS
            for tag, flags in variants:
                yield (f"{name}/{tag}/P={p}", name, flags,
                       lambda name=name, p=p: cs.op_inputs(name, cs.SMALL_O, torch.float32,
                                                           seed=1, p=p))
    for p in (cs.WIDE_P, cs.RAGGED_P):
        for wide, name in cs.WIDE.items():
            for tag, flags in ([("", cs.SA)] if name == "pct_epi_sums"
                               else [("SA", cs.SA), ("OA", cs.OA)]):
                yield (f"{wide}/{tag}/P={p}", name, flags,
                       lambda name=name, p=p, flags=flags: cs.untied(
                           name, cs.op_inputs(name, cs.SMALL_O, torch.float32, seed=11, p=p,
                                              c=cs.WIDE_C), flags))


def dump_bits(tag: str) -> None:
    out = BITS / tag
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for label, name, flags, make in bit_cases():
        kern, _ = cs.op_fns(name, flags)
        outs = [t.detach().cpu() for t in cs.as_tuple(kern(*make()))]
        torch.save(outs, out / (label.replace("/", "_") + ".pt"))
        n += 1
    print(f"{tag} saved the outputs of {n} f32 kernel calls under {out}", flush=True)


def compare_bits(a: str, b: str) -> int:
    same, differ = 0, 0
    for path in sorted(Path(a).glob("*.pt")):
        other = Path(b) / path.name
        if not other.exists():
            print(f"compare {a} {b}: {path.stem} missing from {b}", flush=True)
            differ += 1
            continue
        xs, ys = torch.load(path), torch.load(other)
        for i, (x, y) in enumerate(zip(xs, ys)):
            if torch.equal(x, y):
                same += 1
                continue
            differ += 1
            d = float((x.double() - y.double()).abs().max())
            print(f"compare {a} {b}: {path.stem} output {i} differs, max abs {d:.3e}",
                  flush=True)
    print(f"compare {a} {b}: {same} outputs the same bits, {differ} not", flush=True)
    if same + differ == 0:
        print(f"compare {a} {b}: no saved outputs under {a}", flush=True)
    return 0 if differ == 0 and same > 0 else 1


def f32_step(tag: str) -> None:
    """The f32 pct train step of the checkout run from, timed by this
    script's own chip_smoke._bench_train."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_step", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    state = {"card": cs.card_line()}
    _, ms, _ = own._bench_train(state, own.MODULES, f"{tag} train_pct_f32",
                                own.PER_PCT_TRAIN_STEP, "float32", own.F32_STEP)
    print(f"{tag} f32 pct train step (B = {own.TRAIN_B}): {ms:.2f} ms | {state['card']}",
          flush=True)


def main() -> int:
    if "--compare" in sys.argv:
        a, b = [x for x in sys.argv[1:] if not x.startswith("--")][:2]
        return compare_bits(a, b)
    if not torch.cuda.is_available():
        print("chip_f32_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = args[0] if args else "this"
    if "--step" in sys.argv:
        f32_step(tag)
        return 0
    registers(tag)
    if "--bits-only" not in sys.argv:
        narrow_times(tag)
        if "--narrow-only" in sys.argv:
            return 0
        wide_times(tag)
        f32_forms(tag)
    if "--times-only" not in sys.argv:
        dump_bits(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
