"""The ``sgaligner::`` custom ops: the serving path's forward kernels as
``torch.library`` operators, so that ``torch.export`` keeps each one as a
single node of the frozen program instead of tracing into its ``ctypes``
launch.

Each op has three bodies: the CPU body is the kernel's plain PyTorch
version, the CUDA body launches the kernel (and counts the launch in
``_build.LAUNCHES``), and the fake body gives the exact output shapes and
dtypes (index outputs included) for tracing. The ops mutate nothing and
their outputs alias no input. They are registered when the module that
defines them is imported; ``load()`` imports every such module, which a
loaded program needs before it runs.

The ops, by the wrapper that calls them:

* ``embed_first`` and ``embed_second`` (``ops/pct_embed.py``): ``(h, sums
  [2, 128])``, the two masked sums stacked;
* ``pct_block_eval`` (``ops/pct_attention.py``);
* ``pct_tail`` and ``pct_tail_indexed`` (``ops/pct_tail.py``): the pool
  without and with its argmax / argmin;
* ``pointnet_pool`` and ``pointnet_pool_argmax``
  (``ops/pointnet_fused.py``): the max over points before its cast,
  without and with the argmax; the padding of a bfloat16 C3 the kernel does
  not take stays inside the CUDA body.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "sgaligner"
MODULES = ("sgaligner_tpu_torch.ops.pct_embed",
           "sgaligner_tpu_torch.ops.pct_attention",
           "sgaligner_tpu_torch.ops.pct_tail",
           "sgaligner_tpu_torch.ops.pointnet_fused")


def define(name: str, schema: str, cpu, cuda, fake):
    """Register ``sgaligner::<name>`` with ``schema`` (arguments and
    results, e.g. ``"(Tensor x) -> Tensor"``) and its three bodies; returns
    the op."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def flagged(fn):
    """``fn`` with its last flag (``with_index``, ``with_argmax``) set: the
    body of an op's indexed form."""
    def body(*args):
        return fn(*args, True)
    return body


def first(fn):
    """The first result of ``fn``: the body of an op whose plain version
    also returns what the op leaves out."""
    def body(*args):
        return fn(*args)[0]
    return body


def load() -> None:
    """Import every module that registers an op of the namespace."""
    for name in MODULES:
        importlib.import_module(name)
