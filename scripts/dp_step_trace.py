"""Trace the port's data-parallel training step: where a dp step's time goes.

The step is ``chip_smoke.py``'s dp timing step: the pct configuration
(pct, gat, rel, attr) at bf16, B = 32 pairs of 32 slots and 512 points,
pooled per rank's block at bucket 128 (``pool_compact_sharded``), head
dropout off, seeded weights. It runs on one rank with the whole batch, then
on DP = 2 ranks of B/2 pairs each (``parallel.launch.run_ranks``, NCCL,
one process and one card a rank), then on one rank again. Each run times
20 steps (host clock, synchronised), then traces 5 more with
``torch.profiler`` (which slows the host: its wall time is longer than the
untraced step's) and reports, a step:

* the device's busy time (the union of its kernels, copies and sets) and
  its idle share of the traced wall time;
* the collectives: the port's ``all_reduce`` / ``broadcast`` calls, their
  bytes, the host time inside them, and their NCCL kernels' device time,
  with the part no other kernel overlaps and the shortest, median and
  longest kernel (a kernel above the shortest waits for the other rank);
* the host: kernel launches and the time it blocks on the device;
* the ranks' skew: how far apart the ranks issue each collective, on the
  host's monotonic clock, which the processes of one machine share.

    python scripts/dp_step_trace.py --out dp_trace.json

It needs two cards. ``--device cpu`` rehearses it on the CPU over gloo,
at small sizes and with no device times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MODULES = ("pct", "gat", "rel", "attr")
DP = 2
SIZES = {"cuda": {"batch": 32, "slots": 32, "points": 512, "bucket": 128,
                  "warmup": 5, "steps": 20, "trace": 5},
         "cpu": {"batch": 4, "slots": 8, "points": 64, "bucket": 16,
                 "warmup": 1, "steps": 2, "trace": 2}}
CPU_THREADS = 2
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
TOP = 8


class Collectives:
    """Records each ``torch.distributed.all_reduce`` / ``broadcast`` call
    while ``on``: (name, host entry ns, host ns inside, bytes)."""

    def __init__(self):
        import torch.distributed as dist

        self.on, self.calls = False, []
        for name in ("all_reduce", "broadcast"):
            setattr(dist, name, self._wrap(name, getattr(dist, name)))

    def _wrap(self, name, fn):
        def call(tensor, *args, **kwargs):
            t0 = time.monotonic_ns()
            out = fn(tensor, *args, **kwargs)
            if self.on:
                self.calls.append((name, t0, time.monotonic_ns() - t0,
                                   tensor.numel() * tensor.element_size()))
            return out
        return call


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _summarise(events, steps: int, wall_ms: float) -> dict:
    """A step's device busy time, NCCL kernels, launches and host waits
    from the profiler's events (times in us)."""
    from torch.autograd import DeviceType

    # the device's kernels, copies and sets (not the annotations that
    # mirror host ranges such as "nccl:all_reduce" on the device's timeline)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    span = [(e.time_range.start, e.time_range.end) for e in dev]
    nccl = [e for e in dev if "nccl" in e.name.lower()]
    rest = [(e.time_range.start, e.time_range.end) for e in dev
            if "nccl" not in e.name.lower()]
    durs = sorted(e.time_range.elapsed_us() for e in nccl)
    busy = _union(span)
    per_kernel: dict = {}
    for e in dev:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "traced_ms": wall_ms / steps,
        "device_busy_ms": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms if dev else None,
        "device_ops": len(dev) / steps,
        "nccl_kernels": len(nccl) / steps,
        "nccl_ms": sum(durs) / 1e3 / steps,
        "nccl_alone_ms": (busy - _union(rest)) / 1e3 / steps,
        "nccl_kernel_us": ([durs[0], statistics.median(durs), durs[-1]] if durs else None),
        "launches": sum(e.name in LAUNCHES for e in cpu) / steps,
        "host_sync_ms": sum(e.time_range.elapsed_us() for e in cpu
                            if e.name in SYNCS) / 1e3 / steps,
        "top_device_ms": [(name, us / 1e3 / steps) for name, us in top],
    }


def _run(mesh, opts: dict, host: dict, dev: str) -> dict:
    import torch

    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.batch import to_device
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.train_step import create_train_state, make_train_step
    from sgaligner_tpu_torch.parallel.mesh import barrier, shard_batch

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = make_cfg(modules=list(MODULES))
    cfg.tpu.max_objects = opts["slots"]
    cfg.tpu.points_per_object = opts["points"]
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.model.dropout = 0.0
    train = create_train_state(build_model(cfg, dev, torch.Generator().manual_seed(0)), cfg)
    step = make_train_step(MODULES, mesh)
    batch = to_device(shard_batch(host, mesh), dev)
    coll = Collectives()
    for _ in range(opts["warmup"]):
        step(train, batch)
    barrier(mesh, dev)
    sync()
    t0 = time.perf_counter()
    for _ in range(opts["steps"]):
        out = step(train, batch)
    sync()
    step_ms = (time.perf_counter() - t0) / opts["steps"] * 1e3
    barrier(mesh, dev)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    coll.on = True
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(opts["trace"]):
            step(train, batch)
        sync()
        traced_ms = (time.perf_counter() - t0) * 1e3
    coll.on = False
    n = opts["trace"]
    res = _summarise(prof.events(), n, traced_ms)
    res.update({
        "step_ms": step_ms, "loss": float(out["loss"]), "device": dev,
        "collectives": len(coll.calls) / n,
        "collective_bytes": sum(c[3] for c in coll.calls) / n,
        "collective_host_ms": sum(c[2] for c in coll.calls) / 1e6 / n,
        "calls": [(c[0], c[1], c[3]) for c in coll.calls]})
    return res


def _rank(mesh, opts: dict, host: dict, work: str) -> None:
    import torch

    if opts["device"] == "cuda":
        dev = f"cuda:{mesh.rank}"
        torch.cuda.set_device(dev)
    else:
        dev = "cpu"
        torch.set_num_threads(CPU_THREADS)
    res = _run(mesh, opts, host, dev)
    (Path(work) / f"rank{mesh.rank}.json").write_text(json.dumps(res))


def _skew(ranks: list) -> dict:
    """How far apart (us) the ranks issue each collective, against rank 0."""
    calls = [r["calls"] for r in ranks]
    if len({len(c) for c in calls}) != 1:
        raise AssertionError(f"ranks made {[len(c) for c in calls]} collectives")
    gaps = [(c[1] - z[1]) / 1e3 for r in calls[1:] for c, z in zip(r, calls[0])]
    if not gaps:
        return {}
    far = sorted(abs(g) for g in gaps)
    return {"median_abs_us": statistics.median(far), "max_abs_us": far[-1],
            "mean_us_later_than_rank0": statistics.fmean(gaps)}


def _line(tag: str, r: dict) -> str:
    idle = r["device_idle_share"]
    kern = r["nccl_kernel_us"]
    return (f"{tag}: {r['step_ms']:.3f} ms a step ({r['traced_ms']:.3f} traced); device "
            f"busy {r['device_busy_ms']:.3f} ms, idle "
            f"{'not measured' if idle is None else f'{idle:.3f}'}; {r['device_ops']:.0f} "
            f"device ops, {r['launches']:.0f} launches, host blocked {r['host_sync_ms']:.3f} "
            f"ms; {r['collectives']:.0f} collectives ({r['collective_bytes']:.0f} B, host "
            f"{r['collective_host_ms']:.3f} ms), {r['nccl_kernels']:.0f} NCCL kernels "
            f"{r['nccl_ms']:.3f} ms (alone {r['nccl_alone_ms']:.3f})"
            + (f", each {kern[0]:.1f} / {kern[1]:.1f} / {kern[2]:.1f} us" if kern else ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="", help="write the readings here as JSON")
    args = ap.parse_args()
    backend = "nccl" if args.device == "cuda" else "gloo"
    opts = {"device": args.device, **SIZES[args.device]}

    import torch

    from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact_sharded
    from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
    from sgaligner_tpu_torch.parallel.launch import run_ranks

    card = "not a card"
    if args.device == "cuda":
        if torch.cuda.device_count() < DP:
            print(f"dp_step_trace: needs {DP} cards, {torch.cuda.device_count()} seen",
                  file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    else:
        torch.set_num_threads(CPU_THREADS)
    print(card, flush=True)
    host = pool_compact_sharded(make_synthetic_batch(
        BatchSpec(opts["batch"], opts["slots"], opts["points"]), seed=0),
        opts["bucket"], DP)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    one = _run(None, opts, host, dev)
    with tempfile.TemporaryDirectory(prefix="dp_trace_") as work:
        run_ranks(_rank, DP, backend, opts, host, work)
        ranks = [json.loads((Path(work) / f"rank{r}.json").read_text())
                 for r in range(DP)]
    again = _run(None, opts, host, dev)
    skew = _skew(ranks)
    print(_line(f"dp=1, B={opts['batch']}", one))
    print(_line(f"dp=1 again, B={opts['batch']}", again))
    for r, res in enumerate(ranks):
        print(_line(f"dp={DP} over {backend}, rank {r}", res))
    print("skew of the ranks' collective calls (host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in skew.items()))
    for tag, res in (("dp=1", one), (f"dp={DP} rank 0", ranks[0])):
        print(f"top device time a step, {tag}: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in res["top_device_ms"]))
    print(f"| {card}")
    if args.out:
        for res in (one, again, *ranks):
            res.pop("calls")
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "backend": backend, "opts": opts, "dp1": [one, again],
             "ranks": ranks,
             "skew": skew}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
