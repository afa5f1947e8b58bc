"""Build and load the port's CUDA kernels (``sgaligner_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, one ``nvcc`` per source started together, into
``<repo>/build/kernels/<hash of sources and flags>/`` (listed in
``.gitignore``), so a fresh checkout builds once and later processes reuse it.

Every wrapper that launches a kernel adds one to its entry of ``LAUNCHES``,
right where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: dict[str, int] = {"embed_first": 0, "embed_second": 0,
                            "pct_block_eval": 0, "pct_tail": 0,
                            "pointnet_fwd": 0, "pointnet_bwd": 0,
                            "embed_first_bwd": 0, "embed_second_bwd": 0,
                            "pct_block_fwd": 0, "pct_epi_sums": 0,
                            "pct_block_res_bwd": 0, "pct_tail_bwd": 0,
                            "pct_attn_fwd": 0, "pct_attn_bwd": 0,
                            "pct_block_bwd": 0,
                            # the block kernels at C = 256 (FullPCT's OA blocks)
                            "pct_block_eval_c256": 0, "pct_block_fwd_c256": 0,
                            "pct_epi_sums_c256": 0, "pct_block_res_bwd_c256": 0}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels are built on a machine "
                           "with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this exact set is not built yet); returns the
    library path. Raises with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libsga_kernels.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs), "-lcuda"],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(tmp) / "build.log", out_dir / "build.log")
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False)
    return lib_path


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "sga_embed_first": [_P, _P, _P, _P, _F, _I, _F, _I, _I, _I, _P],
    "sga_embed_second": [_P, _P, _P, _P, _P, _P, _F, _I, _F, _I, _I, _I, _P],
    "sga_pct_block_eval": [_P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _F, _P,
                           _I, _I, _I, _I, _P],
    "sga_pct_tail": [_P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P, _P, _I,
                     _I, _I, _I, _I, _P],
    "sga_pointnet_fwd": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I,
                         _P],
    "sga_pointnet_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I,
                         _I, _I, _P],
    "sga_embed_first_bwd": [_P, _P, _P, _P, _F, _F, _F, _I, _F, _I, _I, _I,
                            _P],
    "sga_embed_second_bwd": [_P, _P, _P, _P, _P, _P, _F, _F, _P, _F, _I, _F,
                             _I, _I, _I, _P],
    "sga_pct_block_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _F, _I,
                          _F, _I, _I, _I, _I, _P],
    "sga_pct_epi_sums": [_P, _F, _F, _P, _F, _I, _F, _L, _I, _P],
    "sga_pct_block_res_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F,
                              _P, _P, _F, _I, _F, _I, _I, _I, _I, _P],
    "sga_pct_block_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _F,
                          _I, _F, _I, _I, _I, _I, _P],
    "sga_pct_attn_fwd": [_P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _P],
    "sga_pct_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _F, _I, _F, _I, _I, _I,
                         _I, _P],
    "sga_pct_tail_bwd": [_P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P, _P,
                         _P, _P, _P, _P, _P, _F, _I, _F, _I, _I, _I, _I, _P],
    # queries (no launch): scratch sizes
    "sga_pointnet_grad_total": [_I],
    "sga_pointnet_bwd_work_bytes": [_I, _I, _I, _I],
    "sga_pct_epi_sums_rows_per_block": [_I],
    "sga_embed_first_bwd_rows_per_block": [_I],
    "sga_pct_bwd_work_bytes": [_I, _I, _I],
}
# the C = 256 forms of the block kernels take the C = 128 forms' arguments
_SIGNATURES.update({f"{name}_c256": _SIGNATURES[name] for name in (
    "sga_pct_block_eval", "sga_pct_block_fwd", "sga_pct_epi_sums",
    "sga_pct_block_res_bwd", "sga_pct_bwd_work_bytes")})
_SIGNATURES["sga_pct_epi_sums_c256_rows_per_block"] = [_I]
_RESTYPES = {"sga_pct_bwd_work_bytes": ctypes.c_longlong,
             "sga_pct_bwd_work_bytes_c256": ctypes.c_longlong,
             "sga_pointnet_bwd_work_bytes": ctypes.c_longlong}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        handle.sga_error_string.argtypes = [ctypes.c_int]
        handle.sga_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, tensors: dict, dtype: torch.dtype | None = None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    of ``dtype`` where given (the kernels take float32 and bfloat16)."""
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dtype is not None and dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} has no kernel "
                         "(float32 and bfloat16 only)")


def slice_stride(n: int) -> int:
    """Floats of one block's slice of a partial-sum scratch buffer
    (``slice_stride`` in csrc/common.cuh)."""
    return (n + 63) // 64 * 64


def grid_blocks(device: torch.device, work: int, per_sm: int = 2) -> int:
    """Blocks for a grid-stride launch that keeps one scratch slice per
    block: ``per_sm`` per multiprocessor, at most one per work item."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(int(work), sms * per_sm))


@functools.lru_cache(maxsize=64)
def stream_blocks(query: str, rows: int, code: int, device: torch.device) -> int:
    """Blocks of one streaming-reduction launch over ``rows`` rows: two per
    multiprocessor, at most one per step of rows a block takes (the
    library's answer to ``query`` for the dtype code: its row lanes times
    its unroll)."""
    step = getattr(lib(), query)(code)
    return grid_blocks(device, -(-rows // step))


def warpgroup_slices(device: torch.device, items: int) -> int:
    """Sum slices of a persistent wgmma launch (one block per
    multiprocessor, at most one per work item) whose two consumer
    warpgroups each keep a slice."""
    return 2 * grid_blocks(device, items, per_sm=1)


def scratch(device: torch.device, blocks: int, n: int) -> torch.Tensor:
    """``blocks`` partial-sum slices of ``n`` floats (uninitialised: every
    kernel writes or zeroes its own slice before adding to it)."""
    return torch.empty((blocks, slice_stride(n)), dtype=torch.float32,
                       device=device)


def check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on the current stream of ``device``, count the
    launch, and raise if it reports a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), fn_name)(*args, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        msg = lib().sga_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
