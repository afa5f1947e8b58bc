"""Start ``dp`` local ranks, one process each, joined in one process group.

``torchrun`` launches the CLIs (``parallel.mesh.init_from_launcher``).
``run_ranks(fn, dp, backend, *args)`` is for a program that starts its own
ranks on one machine, as the tests and ``chip_smoke.py`` do: it spawns
``dp`` processes; each joins a group over ``tcp://localhost:<free port>``
with ``backend``, calls ``fn(mesh, *args)`` and leaves the group. ``fn``
and ``args`` travel by pickle, so ``fn`` is a module-level function. A rank
that raises, or a run past ``timeout`` seconds, raises here, after every
rank process has been stopped.
"""

from __future__ import annotations

import socket
import time
from datetime import timedelta

import torch.distributed as dist
import torch.multiprocessing as mp

from sgaligner_tpu_torch.parallel.mesh import make_mesh


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, dp: int, backend: str, address: str, timeout: float,
               args: tuple) -> None:
    dist.init_process_group(backend, init_method=address, world_size=dp, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        fn(make_mesh(dp), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, dp: int, backend: str, *args, timeout: float = 600.0) -> None:
    """Run ``fn(mesh, *args)`` on ``dp`` new processes, one rank each, and
    wait for all of them."""
    address = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(_rank_main,
                             args=(fn, dp, backend, address, timeout, args),
                             nprocs=dp, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{dp} ranks of {fn.__name__} still running after "
                                   f"{timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
