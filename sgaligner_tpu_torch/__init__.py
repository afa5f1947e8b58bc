"""sgaligner_tpu_torch — the PyTorch / CUDA port of sgaligner_tpu.

A second package beside the JAX one, which stays the reference the port is
tested against. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path becomes a hand-written CUDA kernel for Hopper (``csrc/``, built
with nvcc at first use, see ``ops/_build.py``). Entry points run on the card
unless the caller passes ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.

Ported so far: training, evaluation and serving of the 4-modality
``('pct', 'gat', 'rel', 'attr')`` aligner and of the point configuration
``('point', 'gat', 'rel', 'attr')``; training and evaluation of the EVA
baseline ``('point', 'gcn', 'rel', 'attr')``; the epoch trainer with its
``.pth.tar`` snapshots and resume (``engine.trainer``) and the training
CLIs; the Scan3R data path, the tester's alignment metrics and its CLIs on
trained snapshots (``engine.tester``, ``cli/``); the offset-attention encoder family
(``models.pct.OABlock`` and ``SPCT``, eval and train); and the attention
ops ``ops.pct_attention.pct_attention_fused`` and ``pct_block_fused`` with
their gradients. Every Pallas kernel of the JAX package has its CUDA
counterpart at C = 128 (the PointNet pair at any width). Each module
names its JAX counterpart in ``sgaligner_tpu/`` in its docstring.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (importing the package loads no model code)."""
    if name == "MultiModalEncoder":
        from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder

        return MultiModalEncoder
    if name in ("Config", "make_cfg"):
        from sgaligner_tpu_torch.core import config

        return getattr(config, name)
    if name == "build_model":
        from sgaligner_tpu_torch.engine.factory import build_model

        return build_model
    if name in ("make_serving_step", "serve_queue", "make_train_step",
                "make_eval_step", "create_train_state"):
        from sgaligner_tpu_torch.engine import train_step

        return getattr(train_step, name)
    raise AttributeError(name)
