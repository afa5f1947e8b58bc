"""Train / val entry point for the EVA baseline.

Counterpart of ``sgaligner_tpu/cli/trainval_eva.py``: the flags and the
body of ``trainval_sgaligner`` (``train`` for a config given as a dict);
``model_name: 'eva'`` in the config selects EVA and its NCA objective:

    python -m sgaligner_tpu_torch.cli.trainval_eva --config CFG.yaml --device cpu
"""

from __future__ import annotations

from sgaligner_tpu_torch.cli.trainval_sgaligner import main, train

__all__ = ["main", "train"]

if __name__ == "__main__":
    raise SystemExit(main())
