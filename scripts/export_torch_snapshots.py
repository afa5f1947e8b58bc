#!/usr/bin/env python
"""Write the tracked aligner snapshots as upstream-layout .pth.tar copies.

    python scripts/export_torch_snapshots.py [--names point full eva] [--out DIR]

Reads each ``checkpoints/aligner_<name>`` (an orbax OCDBT store the JAX
package wrote) with the port's ``read_ocdbt_snapshot`` (needs
``tensorstore``; no JAX), maps the model's tree onto the port's state_dict
with ``state_dict_from_flax`` and writes ``{"model": state_dict, "epoch",
"iteration"}`` to ``checkpoints/torch/aligner_<name>.pth.tar``. A machine
without ``tensorstore`` loads the snapshots from these copies. Run it again
whenever a tracked snapshot changes; ``tests/test_torch_snapshots.py``
holds the copies array-equal to the stores.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)


def export(name: str, out_dir: str) -> str:
    from sgaligner_tpu_torch.core.checkpoint import (read_ocdbt_snapshot,
                                                     save_torch_snapshot,
                                                     state_dict_from_flax)
    from chip_smoke import CHECKPOINTS, snapshot_quality

    blob = read_ocdbt_snapshot(str(CHECKPOINTS / f"aligner_{name}"))
    params = blob["params"]["model"]
    sd = state_dict_from_flax(params, blob.get("batch_stats"),
                              tuple(snapshot_quality(name)["modules"]))
    path = osp.join(out_dir, f"aligner_{name}.pth.tar")
    return save_torch_snapshot(path, sd, blob["epoch"], blob["iteration"])


def main(argv=None) -> int:
    from chip_smoke import CHECKPOINTS, SNAPSHOTS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--names", nargs="+", default=list(SNAPSHOTS),
                    choices=list(SNAPSHOTS))
    ap.add_argument("--out", default=str(CHECKPOINTS / "torch"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in args.names:
        path = export(name, args.out)
        print(f"{name} -> {path} ({osp.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
