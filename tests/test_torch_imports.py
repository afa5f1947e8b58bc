"""The port and chip_smoke.py import no JAX and nothing of the JAX package.

Each check runs in a fresh interpreter and inspects ``sys.modules``. The JAX
package is matched by its exact name or its submodules
(``sgaligner_tpu.``), not by prefix: ``sgaligner_tpu_torch`` must not count.
"""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "sgaligner_tpu")
print(json.dumps(sorted(m for m in sys.modules
                        if any(m == b or m.startswith(b + ".") for b in banned))))
"""


def _port_modules():
    import sgaligner_tpu_torch

    names = ["sgaligner_tpu_torch"]
    for info in pkgutil.walk_packages(sgaligner_tpu_torch.__path__,
                                      "sgaligner_tpu_torch."):
        names.append(info.name)
    return names


def _imported_banned(names):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE, *names], cwd=REPO,
                         env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_modules_are_listed():
    names = _port_modules()
    for expected in ("sgaligner_tpu_torch.ops.pct_attention",
                     "sgaligner_tpu_torch.engine.train_step",
                     "sgaligner_tpu_torch.core.checkpoint",
                     "sgaligner_tpu_torch.ops.pointnet_fused",
                     "sgaligner_tpu_torch.ops.objective",
                     "sgaligner_tpu_torch.ops.losses",
                     "sgaligner_tpu_torch.models.pointnet",
                     "sgaligner_tpu_torch.engine.factory"):
        assert expected in names


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_imported(target):
    names = _port_modules() if target == "package" else ["chip_smoke"]
    assert _imported_banned(names) == []


def test_probe_matches_the_jax_package_exactly():
    """The probe would see the JAX package itself (and only by exact name):
    importing its jax-free config module is reported."""
    assert _imported_banned(["sgaligner_tpu.core.config"]) == [
        "sgaligner_tpu", "sgaligner_tpu.core", "sgaligner_tpu.core.config"]
