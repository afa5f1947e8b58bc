#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sgaligner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (every failure raises and exits non-zero):
  device   card name, power limit; TF32 off for f32 products and convolutions
  build    nvcc builds the kernels from sgaligner_tpu_torch/csrc
  kernels  each of the four kernels against its plain PyTorch version on the
           card: full width (P=512, C=128, da=32, K=1024), O=67 objects
           (ragged, not a multiple of 8), float32 and bfloat16, SA and OA;
           again at P=200 (not a multiple of the kernels' 64-row tiles)
  parity   the serving path on the CPU (plain versions) against the card
           (kernels): same seeded weights, one pooled B=8 batch, float32
  serve    the serving configuration of bench.py (B=512 pairs, 32 object
           slots per graph, 512 points, bfloat16, pooled bucket 128): four
           requests with distinct seeds through make_serving_step; launch
           counts 1/1/4/1 per request
  time     each kernel at the serving shapes against its plain version (and
           torch.matmul for the tail), with its bound from the shapes

The last two lines are the {"kernels": [...]} record and
{"ok": true, "device": {...}}. Nothing of JAX or of the JAX package is
imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger of
# bytes / memory rate and operations / peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

P, C, DA, K = 512, 128, 32, 1024
SMALL_O = 67
RAGGED_P = 200
MODULES = ("pct", "gat", "rel", "attr")

# Normwise tolerance, max|kernel - plain| / max|plain| per output. float32:
# the same f32 arithmetic summed in another order. bfloat16: an output may
# round to the neighbouring bf16 value (2^-8 relative); pct_block_eval also
# exponentiates differently (f32 log-sum-exp in the kernel, bf16 exp against a
# column max in the plain version, as on the TPU).
TOL = {("embed_first", "f32"): 1e-5, ("embed_first", "bf16"): 1e-2,
       ("embed_second", "f32"): 1e-4, ("embed_second", "bf16"): 1e-2,
       ("pct_block_eval", "f32"): 1e-4, ("pct_block_eval", "bf16"): 5e-2,
       ("pct_tail", "f32"): 1e-4, ("pct_tail", "bf16"): 1e-2}
# main path, CPU against the card at float32: relative drift of the joint
# embeddings (the JAX suite measured 0.0077 f32 drift from max-pool ties)
PARITY_DRIFT = 0.02

KERNELS = {
    "embed_first": ("sgaligner_tpu_torch/csrc/pct_embed.cu",
                    "sgaligner_tpu/ops/pct_embed.py:46"),
    "embed_second": ("sgaligner_tpu_torch/csrc/pct_embed.cu",
                     "sgaligner_tpu/ops/pct_embed.py:195"),
    "pct_block_eval": ("sgaligner_tpu_torch/csrc/pct_attention.cu",
                       "sgaligner_tpu/ops/pct_attention.py:833"),
    "pct_tail": ("sgaligner_tpu_torch/csrc/pct_tail.cu",
                 "sgaligner_tpu/ops/pct_tail.py:83"),
}
# positions of the per-object arguments of each op (the rest are weights)
PER_OBJECT_ARGS = {"embed_first": (0, 2), "embed_second": (0, 4),
                   "pct_block_eval": (0,), "pct_tail": (0, 1, 2, 3, 5)}
PER_REQUEST = {"embed_first": 1, "embed_second": 1, "pct_block_eval": 4,
               "pct_tail": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median milliseconds of fn() by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------- inputs --------------------------------------

def op_inputs(name: str, o: int, dtype, seed: int, p: int = P) -> tuple:
    """Seeded inputs of one op at full width (p points per object), on the
    card."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    mask = (torch.rand(o, 1, generator=g) < 0.85).float()
    mask[0] = 1.0
    mask = mask.to("cuda", dtype)
    if name == "embed_first":
        return rnd(o, 3, p), rnd(3, C), mask
    if name == "embed_second":
        return (rnd(o, p, C), rnd(1, C, scale=0.5), rnd(1, C, scale=0.1),
                rnd(C, C, scale=C ** -0.5), mask)
    if name == "pct_block_eval":
        wbn = (torch.rand(C, generator=g) + 0.5).cuda()
        return (rnd(o, p, C), rnd(C, DA, scale=C ** -0.5),
                rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1),
                rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1), wbn,
                (torch.randn(C, generator=g) * 0.1).cuda())
    return (*(rnd(o, p, C) for _ in range(4)), rnd(4 * C, K, scale=(4 * C) ** -0.5),
            mask)


def op_fns(name: str, flags=(True, False)):
    """(kernel wrapper, plain version) of one op."""
    from sgaligner_tpu_torch.ops import pct_attention, pct_embed, pct_tail

    if name == "embed_first":
        return pct_embed.embed_first, pct_embed.embed_first_plain
    if name == "embed_second":
        return pct_embed.embed_second, pct_embed.embed_second_plain
    if name == "pct_tail":
        return pct_tail.pct_tail, pct_tail.pct_tail_plain
    scale, double_norm = flags

    def kern(*a):
        return pct_attention.pct_block_eval(*a, scale=scale, double_norm=double_norm)

    def plain(*a):
        return pct_attention.block_eval_plain(*a, scale=scale, double_norm=double_norm)

    return kern, plain


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare(got, want) -> tuple[float, float]:
    """(max abs error over the per-object outputs, max normwise relative
    error over all outputs). The [1, ·] BN sums add up O·P values, so their
    absolute error scales with O·P; they are held by the relative check."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(as_tuple(got), as_tuple(want)):
        g, w = g.double(), w.double()
        if not bool(g.isfinite().all()):
            raise AssertionError("kernel output is not finite")
        err = float((g - w).abs().max())
        if g.shape[0] != 1:
            worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(w.abs().max()), 1e-30))
    return worst_abs, worst_rel


# ------------------------------- phases --------------------------------------

def phase_device(state: dict) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["kind"] = torch.cuda.get_device_name(0)
    state["card"] = card_line()
    log(f"[device] {state['kind']} | nvidia-smi: {state['card']} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")


def phase_build(state: dict) -> None:
    from sgaligner_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {time.perf_counter() - t0:.1f} s "
        f"(cached={_build.build_info['cached']}) {_build.build_info['path']}")
    build_log = Path(_build.build_info["path"]).parent / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            if "Compiling entry" in line or "Used" in line or spills:
                log(f"[build] {line.strip()}")


def phase_kernels(state: dict) -> None:
    import torch

    # P=512 as on the main path, then a ragged P (not a multiple of the
    # kernels' 64-row tiles)
    cases = [(dt_name, dtype, p) for p in (P, RAGGED_P)
             for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    for dt_name, dtype, p in cases:
        for name in KERNELS:
            variants = ([("SA", (True, False)), ("OA", (False, True))]
                        if name == "pct_block_eval" else [("", None)])
            for tag, flags in variants:
                kern, plain = op_fns(name, flags or (True, False))
                args = op_inputs(name, SMALL_O, dtype, seed=1, p=p)
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err_abs, err_rel = compare(got, want)
                ms = cuda_ms(lambda: kern(*args))
                plain_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
                tol = TOL[(name, dt_name)]
                label = f"{name}{'/' + tag if tag else ''}/{dt_name}"
                log(f"[kernels] {label:24s} O={SMALL_O} P={p} max_abs={err_abs:.3e} "
                    f"max_rel={err_rel:.3e} (tol {tol:g}) kernel {ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms")
                if not err_rel <= tol:
                    raise AssertionError(f"{label}: kernel disagrees with the "
                                         f"plain version ({err_rel:.3e} > {tol:g})")


def _cfg(dtype: str, max_objects: int):
    from sgaligner_tpu_torch.core.config import make_cfg

    cfg = make_cfg(modules=list(MODULES))
    cfg.tpu.max_objects = max_objects
    cfg.tpu.points_per_object = P
    cfg.tpu.compute_dtype = dtype
    return cfg


def _valid(batch, emb):
    import torch

    mask = torch.as_tensor(batch["obj_mask"]).reshape(-1).to(emb.device)
    return emb[mask]


def phase_parity(state: dict) -> None:
    import numpy as np
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import make_serving_step

    cfg = _cfg("float32", 32)
    host = pool_compact(make_synthetic_batch(
        BatchSpec(8, 32, P), seed=3, bow_noise=1.0, resample=True), 128)
    outs, embs = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, torch.Generator().manual_seed(11))
        batch = to_device(host, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            embs[dev] = {k: v.double().cpu() for k, v in model(batch).items()}
            outs[dev] = make_serving_step(model, MODULES)(batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[parity] {dev}: forward + serving step {time.perf_counter() - t0:.1f} s")
    o = host["obj_points_pooled"].shape[0]
    for m in (*MODULES, "joint"):
        ref = _valid(host, embs["cpu"][m])
        got = _valid(host, embs["cuda"][m])
        if not bool(got.isfinite().all()):
            raise AssertionError(f"parity: {m} embeddings not finite on the card")
        drift = float((got - ref).abs().max() / ref.abs().max())
        log(f"[parity] O={o} {m:6s} relative drift {drift:.3e} (bound {PARITY_DRIFT})")
        if not drift <= PARITY_DRIFT:
            raise AssertionError(f"parity: {m} drift {drift:.3e} > {PARITY_DRIFT}")
    cpu, gpu = outs["cpu"], outs["cuda"]
    for k in ("rr_count", "hits@1"):
        a = cpu[k][-1] if isinstance(cpu[k], tuple) else cpu[k]
        b = gpu[k][-1] if isinstance(gpu[k], tuple) else gpu[k]
        if int(a) != int(b):
            raise AssertionError(f"parity: {k} totals differ: {int(a)} vs {int(b)}")
    count = int(cpu["rr_count"])
    rr_c, rr_g = float(cpu["rr_sum"]), float(gpu["rr_sum"])
    hit_c, hit_g = int(cpu["hits@1"][0]), int(gpu["hits@1"][0])
    al_c = cpu["alignment_score"].cpu().numpy()
    al_g = gpu["alignment_score"].cpu().numpy()
    log(f"[parity] anchors {count}: MRR cpu {rr_c / count:.6f} card {rr_g / count:.6f}; "
        f"hits@1 {hit_c} / {hit_g}; alignment_score mean {al_c.mean():.6f} / {al_g.mean():.6f}")
    # a rank may flip where two candidates' similarities are within the drift
    if abs(rr_c - rr_g) > 0.02 * count or abs(hit_c - hit_g) > max(1, 0.02 * count) \
            or float(np.abs(al_c - al_g).max()) > 0.1:
        raise AssertionError("parity: serving metrics differ between CPU and card")


def phase_serve(state: dict) -> None:
    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import make_serving_step
    from sgaligner_tpu_torch.ops import _build

    b = 512
    cfg = _cfg("bfloat16", 32)
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    step = make_serving_step(model, MODULES)
    t0 = time.perf_counter()
    hosts = [pool_compact(make_synthetic_batch(BatchSpec(b, 32, P), seed=100 + i), 128)
             for i in range(4)]
    batches = [to_device(h, "cuda") for h in hosts]
    torch.cuda.synchronize()
    os_ = [h["obj_points_pooled"].shape[0] for h in hosts]
    log(f"[serve] set-up {time.perf_counter() - t0:.1f} s; pooled objects O per request {os_}")
    state["serve_o"] = max(os_)

    with torch.inference_mode():                     # warm-up (not counted)
        embs = model(batches[0])
        for k, v in embs.items():
            if not bool(v.isfinite().all()):
                raise AssertionError(f"serve: {k} embeddings not finite")
        step(batches[0])
    torch.cuda.synchronize()

    _build.reset_launches()
    times, outs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(_build.LAUNCHES)
    state["launches"] = launches
    for name, per in PER_REQUEST.items():
        if launches[name] != per * len(batches):
            raise AssertionError(f"serve: {name} launched {launches[name]} times, "
                                 f"expected {per} x {len(batches)}")
    for i, out in enumerate(outs):
        for k, v in out.items():
            vals = v if isinstance(v, tuple) else (v,)
            for t in vals:
                if not bool(torch.as_tensor(t).double().isfinite().all()):
                    raise AssertionError(f"serve: request {i} {k} not finite")
        log(f"[serve] request {i}: O={os_[i]} {times[i] * 1e3:.1f} ms "
            f"({b / times[i]:.1f} pairs/s) MRR {float(out['rr_sum']) / int(out['rr_count']):.4f} "
            f"| {state['card']}")
    med = statistics.median(times)
    state["serve_ms"] = med * 1e3
    log(f"[serve] median {med * 1e3:.1f} ms per request, {b / med:.1f} pairs/s "
        f"(B={b}, bf16) | launches {launches} | {state['card']}")


def bound(name: str, o: int) -> tuple[float, str]:
    """Least time (ms) for the work of one call at O objects, bf16."""
    e = 2  # bytes per bf16 element
    if name == "embed_first":
        nbytes = o * 3 * P * e + 3 * C * e + o * e + o * P * C * e + 2 * C * 4
        ops, rate = 2 * 3 * C * o * P, F32_FLOPS
    elif name == "embed_second":
        nbytes = 2 * o * P * C * e + C * C * e + 2 * C * e + o * e + 2 * C * 4
        ops, rate = 2 * o * P * C * C, BF16_TENSOR_FLOPS
    elif name == "pct_block_eval":
        nbytes = 2 * o * P * C * e + (C * DA + 2 * C * C + 2 * C) * e + 2 * C * 4
        ops = o * (2 * P * C * (DA + C) + 2 * P * P * DA + 2 * P * P * C + 2 * P * C * C)
        rate = BF16_TENSOR_FLOPS
    else:
        nbytes = 4 * o * P * C * e + 4 * C * K * e + o * e + 2 * o * K * 4 + 2 * K * 4
        ops, rate = 2 * o * P * 4 * C * K, BF16_TENSOR_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_time(state: dict) -> None:
    import torch

    o = state["serve_o"]
    chunk = 1024
    rows = []
    for name, (source, replaces) in KERNELS.items():
        kern, plain = op_fns(name)
        args = op_inputs(name, o, torch.bfloat16, seed=2)
        got = as_tuple(kern(*args))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(*args))
        # the plain version in object chunks (it materialises [O, P, P] or
        # [O, P, K] intermediates): per-object outputs are concatenated, the
        # [1, ·] sums added up
        plain_total, parts = 0.0, []
        for lo in range(0, o, chunk):
            sub = tuple(a[lo:lo + chunk] if i in PER_OBJECT_ARGS[name] else a
                        for i, a in enumerate(args))
            plain_total += cuda_ms(lambda: plain(*sub), warmup=1, reps=1)
            parts.append(as_tuple(plain(*sub)))
        want = [sum(outs[1:], outs[0]) if outs[0].shape[0] == 1 else torch.cat(outs)
                for outs in zip(*parts)]
        err_abs, err_rel = compare(tuple(got), tuple(want))
        tol = TOL[(name, "bf16")]
        if not err_rel <= tol:
            raise AssertionError(f"time: {name} at O={o} disagrees with the plain "
                                 f"version ({err_rel:.3e} > {tol:g})")
        library_ms = None
        if name == "pct_tail":
            cat_x = torch.cat(args[:4], dim=-1).reshape(o * P, 4 * C)
            library_ms = cuda_ms(lambda: torch.matmul(cat_x, args[4]))
            del cat_x
        b_ms, b_by = bound(name, o)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": state["launches"][name],
               "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_total,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        log(f"[time] {name:15s} O={o} bf16 kernel {ms:.3f} ms | plain {plain_total:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by}) | library {library_ms} | max_abs {err_abs:.3e} "
            f"max_rel {err_rel:.3e} | {state['card']}")
        rows.append(row)
        del args, got, parts, want
        torch.cuda.empty_cache()
    per_req = sum(PER_REQUEST[r["name"]] * r["ms"] for r in rows)
    log(f"[time] the kernels at O={o} take {per_req:.1f} ms per request "
        f"({PER_REQUEST}); median request {state['serve_ms']:.1f} ms, so "
        f"{per_req / state['serve_ms']:.1%} of it | {state['card']}")
    state["rows"] = rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "sgaligner_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port (sgaligner_tpu_torch/) is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    state: dict = {}
    phase_device(state)
    for name, phase in (("build", phase_build), ("kernels", phase_kernels),
                        ("parity", phase_parity), ("serve", phase_serve),
                        ("time", phase_time)):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(state["card"])
    print(json.dumps({"kernels": state["rows"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
