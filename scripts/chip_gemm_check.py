#!/usr/bin/env python3
"""block_gemm's register-tiled f32 product alone on one NVIDIA GPU: the
rate it reaches at each shape the C = 256 passes call it with, and the SM
clock while it runs.

    python3 scripts/chip_gemm_check.py

Run from the repo root. Builds scripts/block_gemm_bench.cu (which includes
sgaligner_tpu_torch/csrc/common.cuh) with nvcc into build/, then for each
shape launches one block an SM (132 on an H100) that multiplies tiles
resident in shared memory over and over, times it with CUDA events and
prints TFLOP/s beside the card's 67 TFLOP/s f32 rate (chip_smoke.F32_FLOPS),
and the SM clock nvidia-smi reads during a longer run of the largest shape.
The passes' own times (scripts/chip_f32_check.py) sit at these rates, so
they say how far a pass can go on this product.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading
from pathlib import Path

import torch

# entry: (M, N, K) of C[M, N] += A[M, K]·B[K, N]
SHAPES = {"nn_64_32_256": (64, 32, 256), "bc_64_32_256": (64, 32, 256),
          "bc_64_64_64": (64, 64, 64), "nn_64_64_64": (64, 64, 64),
          "nn_64_256_64": (64, 256, 64), "bc_64_256_32": (64, 256, 32),
          "ac_256_32_64": (256, 32, 64), "ac_256_256_64": (256, 256, 64),
          "ac_64_256_64": (64, 256, 64), "nn_64_128_128": (64, 128, 128)}
F32_FLOPS = 67e12
SMEM = 200 * 1024


def build() -> ctypes.CDLL:
    out = Path("build") / "block_gemm_bench.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", "sgaligner_tpu_torch/csrc", "scripts/block_gemm_bench.cu",
                    "-o", str(out)], check=True)
    return ctypes.CDLL(str(out))


def clocks(samples: list, stop: threading.Event) -> None:
    while not stop.is_set():
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader"], capture_output=True, text=True)
        samples.append(r.stdout.strip())
        stop.wait(0.2)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gemm_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms, device="cuda")
    gc = torch.zeros(sms * 256 * 260, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def run(name: str, reps: int) -> float:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        if fn(out.data_ptr(), gc.data_ptr(), sms, reps, SMEM, st) != 0:
            raise RuntimeError(f"{name}: launch failed")
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    for name, (m, n, k) in SHAPES.items():
        reps = max(8, int(2e11 / (2 * m * n * k * sms)))
        run(name, reps)
        ms = run(name, reps)
        rate = 2 * m * n * k * reps * sms / ms / 1e9
        print(f"block_gemm f32 {name} [{m}x{n}, K={k}]: {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / F32_FLOPS:.0%} of 67), {reps} products a block | {card}",
              flush=True)
    samples: list = []
    stop = threading.Event()
    t = threading.Thread(target=clocks, args=(samples, stop))
    t.start()
    ms = run("nn_64_256_64", int(8e13 / (2 * 64 * 256 * 64 * sms)))
    stop.set()
    t.join()
    print(f"block_gemm f32 nn_64_256_64 for {ms:.0f} ms: nvidia-smi clocks.sm, power.draw "
          f"samples {samples[1:-1] or samples} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
