#!/usr/bin/env python3
"""The port's f32 CUDA-core products alone on one NVIDIA GPU: block_gemm's
register-tiled product at each shape the C = 256 passes call it with, the
f32 mainloop (csrc/tail_f32.cuh) on the kernels' own jobs, and the SM clock
while block_gemm runs.

    python3 scripts/chip_gemm_check.py [--embed-only]

Run from the repo root. Builds scripts/block_gemm_bench.cu (which includes
sgaligner_tpu_torch/csrc/common.cuh) with nvcc into build/, then for each
shape launches one block an SM (132 on an H100) that multiplies tiles
resident in shared memory over and over, times it with CUDA events and
prints TFLOP/s beside the card's 67 TFLOP/s f32 rate (chip_smoke.F32_FLOPS),
and the SM clock nvidia-smi reads during a longer run of the largest shape.
Then builds scripts/tail_gemm_bench.cu and times the mainloop over operands
in device memory at O = 896, P = 512 on the kernels' own jobs: the tail's
three products (K = 1024: z = x·W, dX = G·Wᵀ, dW = xᵀ·G) and three of the
f32 C = 128 attention passes' (the apply pass's key loop with its prep, the
dq pass's dual product, the projection), two blocks an SM, and the f32
embed_second pair's (the h product by both staging routes and through a
4-stage ring, the backward's dW1 and dx0 products side by side; these alone
with --embed-only), with an epilogue that only keeps a checksum. The
passes' own times (scripts/chip_f32_check.py) sit at these rates, so they
say how far a pass can go on this product.
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
          "ac_64_256_64": (64, 256, 64)}
F32_FLOPS = 67e12
SMEM = 200 * 1024


# the mainloop's jobs (scripts/tail_gemm_bench.cu modes) at O = 896, P = 512:
# the tail's three products (K = 1024) and three of the f32 C = 128
# attention passes' products
O, P = 896, 512
TAIL_ROWS, TAIL_K = O * P, 1024
TAIL_MODES = {"tail z = x·W [rows x 1024, K = 512]": 0,
              "tail dX = G·Wᵀ [rows x 512, K = 1024]": 1,
              "tail dW = xᵀ·G [512 x 1024, over the rows]": 2,
              "attention key loop: S, G (prep) and y = G·v [P x 128 a tile, K = P]": 3,
              "dq dual product: v_I·dŶ_Jᵀ beside dŶ_I·v_Jᵀ [128 x 64 each, K = 128]": 4,
              "projection [rows x 160, K = 128]": 5}
# the f32 embed_second pair's products (e2_gemm modes, K = 128) at the same
# O, P: the h product by its two staging routes and through a 4-stage ring,
# and the backward's dW1 and dx0 products side by side
E2_MODES = {"embed h = x0·W1, h0's rows 16 bytes a copy, prologue while transposing": 6,
            "embed h = x0·W1, h0 copied transposed 4 bytes at a time, prologue in place": 7,
            "embed h = x0·W1, 16-byte route, 4-stage ring": 8,
            "embed dW1 = x0ᵀ·dz beside dx0 = dz·W1ᵀ (one launch, 2 x 132 slices)": 9}


def build(name: str = "block_gemm_bench") -> ctypes.CDLL:
    out = Path("build") / f"{name}.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-I", "sgaligner_tpu_torch/csrc", f"scripts/{name}.cu",
                    "-o", str(out)], check=True)
    return ctypes.CDLL(str(out))


def _dq_pairs(p: int) -> int:
    rtiles, chunks = -(-p // 128), -(-p // 64)
    return sum(chunks - 2 * i for i in range(rtiles))


def _flops(mode: int, splits: int) -> float:
    if mode in (0, 1):
        return 2 * TAIL_ROWS * 512 * TAIL_K
    if mode == 2:
        return 2 * (TAIL_ROWS + splits - 1) // splits * splits * 512 * TAIL_K
    if mode == 3:
        return 2 * O * P * P * (32 + 128)
    if mode == 4:
        return O * _dq_pairs(P) * 2 * 2 * 128 * 64 * 128
    return 2 * TAIL_ROWS * 128 * 160


def tail_rates(sms: int, card: str) -> None:
    """The mainloop on the kernels' own jobs (checksum epilogues), CUDA
    events over one launch after a warm-up, two blocks an SM."""
    lib = build("tail_gemm_bench")
    fn, attn = lib.tail_gemm, lib.attn_gemm
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    attn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(TAIL_ROWS, 128, device="cuda", generator=g) for _ in range(4)]
    gr = torch.randn(TAIL_ROWS, TAIL_K, device="cuda", generator=g)
    w = torch.randn(512, TAIL_K, device="cuda", generator=g)
    q = torch.randn(TAIL_ROWS, 32, device="cuda", generator=g) * 0.1
    lse = torch.randn(TAIL_ROWS, device="cuda", generator=g)
    wqk = torch.randn(128, 32, device="cuda", generator=g)
    wv = torch.randn(128, 128, device="cuda", generator=g)
    splits = max(1, 2 * sms // 32)
    out = torch.zeros(256 * max(2 * sms, 32 * splits), device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for label, mode in TAIL_MODES.items():
        if mode < 3:
            ptrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in ([gr] * 4 if mode == 1 else xs)])
            b = gr if mode == 2 else w
            groups = 2 * sms // (8 if mode == 0 else 4)

            def call():
                return fn(mode, ctypes.addressof(ptrs), b.data_ptr(), out.data_ptr(), TAIL_ROWS,
                          groups, splits, st)
        else:
            def call():
                return attn(mode, q.data_ptr(), xs[0].data_ptr(), lse.data_ptr(), wqk.data_ptr(),
                            wv.data_ptr(), out.data_ptr(), O, P, st)
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            if call() != 0:
                raise RuntimeError(f"tail_gemm_bench mode {mode}: launch failed")
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        rate = _flops(mode, splits) / min(ms[1:]) / 1e9
        print(f"mainloop f32 {label}: {min(ms[1:]):.3f} ms, {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / F32_FLOPS:.0%} of 67) at O = {O}, P = {P} | {card}", flush=True)


def e2_rates(sms: int, card: str) -> None:
    """The embed_second pair's products alone (checksum epilogues), CUDA
    events over one launch after a warm-up: the forward's and the dz
    pass's grid (two blocks an SM), the backward's dW1 / dx0 launch (one
    slice a multiprocessor, each with a dW1 and a dx0 block)."""
    lib = build("tail_gemm_bench")
    fn = lib.e2_gemm
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 5, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    h0 = torch.randn(O * P, 128, device="cuda", generator=g)
    w = torch.randn(128, 128, device="cuda", generator=g) * 128 ** -0.5
    wf, bf = torch.randn(128, device="cuda", generator=g), torch.randn(128, device="cuda") * 0.1
    out = torch.zeros(256 * 2 * sms, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    tiles = -(-O * P // 64)
    for label, mode in E2_MODES.items():
        blocks = min(tiles, sms if mode == 9 else 2 * sms)
        ms = []
        for _ in range(4):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            if fn(mode, h0.data_ptr(), w.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                  out.data_ptr(), O, P, blocks, st) != 0:
                raise RuntimeError(f"tail_gemm_bench e2 mode {mode}: launch failed")
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        flops = 2 * O * P * 128 * 128 * (2 if mode == 9 else 1)
        rate = flops / min(ms[1:]) / 1e9
        print(f"mainloop f32 {label}: {min(ms[1:]):.3f} ms, {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / F32_FLOPS:.0%} of 67) at O = {O}, P = {P} | {card}", flush=True)


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if "--embed-only" in sys.argv:
        e2_rates(sms, card)
        return 0
    lib = build()
    out = torch.zeros(sms, device="cuda")
    gc = torch.zeros(sms * 256 * 260, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

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
    e2_rates(sms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
