#!/usr/bin/env python3
"""The port's f32 CUDA-core products alone on one NVIDIA GPU: block_gemm's
register-tiled product at each shape the C = 256 passes call it with, the
f32 tail's mainloop (csrc/tail_f32.cuh) at the tail's three products, and
the SM clock while block_gemm runs.

    python3 scripts/chip_gemm_check.py

Run from the repo root. Builds scripts/block_gemm_bench.cu (which includes
sgaligner_tpu_torch/csrc/common.cuh) with nvcc into build/, then for each
shape launches one block an SM (132 on an H100) that multiplies tiles
resident in shared memory over and over, times it with CUDA events and
prints TFLOP/s beside the card's 67 TFLOP/s f32 rate (chip_smoke.F32_FLOPS),
and the SM clock nvidia-smi reads during a longer run of the largest shape.
Then builds scripts/tail_gemm_bench.cu and times the tail's mainloop over
operands in device memory at O = 896, P = 512, K = 1024 (z = X·W, dX =
G·Wᵀ, dW = Xᵀ·G), two blocks an SM, with an epilogue that only keeps a
checksum. The passes' own times (scripts/chip_f32_check.py) sit at these
rates, so they say how far a pass can go on this product.
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


# the tail's products (scripts/tail_gemm_bench.cu modes) at O = 896, P = 512
TAIL_ROWS, TAIL_K = 896 * 512, 1024
TAIL_MODES = {"z = X·W [rows x 1024, K = 512]": 0, "dX = G·Wᵀ [rows x 512, K = 1024]": 1,
              "dW = Xᵀ·G [512 x 1024, over the rows]": 2}


def build(name: str = "block_gemm_bench") -> ctypes.CDLL:
    out = Path("build") / f"{name}.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-I", "sgaligner_tpu_torch/csrc", f"scripts/{name}.cu",
                    "-o", str(out)], check=True)
    return ctypes.CDLL(str(out))


def tail_rates(sms: int, card: str) -> None:
    """The tail's mainloop at its three products' shapes, CUDA events over
    one launch after a warm-up."""
    lib = build("tail_gemm_bench")
    fn = lib.tail_gemm
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(TAIL_ROWS, 512, device="cuda", generator=g)
    gr = torch.randn(TAIL_ROWS, TAIL_K, device="cuda", generator=g)
    w = torch.randn(512, TAIL_K, device="cuda", generator=g)
    splits = max(1, 2 * sms // 32)
    out = torch.zeros(256 * max(2 * sms, 32 * splits), device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for label, mode in TAIL_MODES.items():
        a, b = {0: (x, w), 1: (gr, w), 2: (x, gr)}[mode]
        groups = 2 * sms // (8 if mode == 0 else 4)
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            if fn(mode, a.data_ptr(), b.data_ptr(), out.data_ptr(), TAIL_ROWS, groups, splits,
                  st) != 0:
                raise RuntimeError(f"tail_gemm mode {mode}: launch failed")
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        rows = TAIL_ROWS if mode < 2 else splits * (TAIL_ROWS // splits // 16 * 16)
        rate = 2 * rows * 512 * TAIL_K / min(ms[1:]) / 1e9
        print(f"tail mainloop f32 {label}: {min(ms[1:]):.3f} ms, {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / F32_FLOPS:.0%} of 67), rows {rows} | {card}", flush=True)


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
    tail_rates(sms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
