"""The port and chip_smoke.py import no JAX and nothing of the JAX package.

Each check runs in a fresh interpreter and inspects ``sys.modules``. The JAX
package is matched by its exact name or its submodules
(``sgaligner_tpu.``), not by prefix: ``sgaligner_tpu_torch`` must not count.
The port's modules, chip_smoke.py and ``scripts/export_torch_snapshots.py``
import neither PyYAML nor tensorstore when imported (each is imported inside
the one function that needs it), and chip_smoke.py's ``quality`` path (the
tracked snapshots through the tester, from the ``.pth.tar`` copies, the
config as a dict) runs with both made unimportable: the card's machine has
neither.
"""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "sgaligner_tpu")
HOST_ONLY = ("yaml", "tensorstore")
EXPORT_SCRIPT = os.path.join(REPO, "scripts", "export_torch_snapshots.py")

_PROBE = r"""
import importlib, importlib.util, json, sys
banned = tuple(json.loads(sys.argv[1]))
for name in sys.argv[2:]:
    if name.endswith(".py"):
        spec = importlib.util.spec_from_file_location("probed_script", name)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(name)
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


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _imported_banned(names, banned=JAX_NAMES):
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(banned), *names],
                         cwd=REPO, env=_env(), capture_output=True, text=True,
                         check=True)
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
                     "sgaligner_tpu_torch.engine.factory",
                     "sgaligner_tpu_torch.engine.tester",
                     "sgaligner_tpu_torch.models.eva",
                     "sgaligner_tpu_torch.data.scan3r",
                     "sgaligner_tpu_torch.data.loaders",
                     "sgaligner_tpu_torch.data.fixtures",
                     "sgaligner_tpu_torch.utils.io",
                     "sgaligner_tpu_torch.cli.inference_align_reg",
                     "sgaligner_tpu_torch.cli.inference_align_eva",
                     "sgaligner_tpu_torch.engine.trainer",
                     "sgaligner_tpu_torch.utils.logging",
                     "sgaligner_tpu_torch.cli.trainval_sgaligner",
                     "sgaligner_tpu_torch.cli.trainval_eva",
                     "sgaligner_tpu_torch.serving",
                     "sgaligner_tpu_torch.api",
                     "sgaligner_tpu_torch.ops.library",
                     "sgaligner_tpu_torch.reg.ransac",
                     "sgaligner_tpu_torch.reg.icp",
                     "sgaligner_tpu_torch.reg.coarse",
                     "sgaligner_tpu_torch.reg.backend",
                     "sgaligner_tpu_torch.reg.metrics",
                     "sgaligner_tpu_torch.reg.evaluator",
                     "sgaligner_tpu_torch.align.alignment",
                     "sgaligner_tpu_torch.utils.pointcloud",
                     "sgaligner_tpu_torch.cli.export_serving",
                     "sgaligner_tpu_torch.cli.demo_align",
                     "sgaligner_tpu_torch.ops.fps",
                     "sgaligner_tpu_torch.reg.geo_model",
                     "sgaligner_tpu_torch.reg.learned",
                     "sgaligner_tpu_torch.reg.learned_batch",
                     "sgaligner_tpu_torch.reg.eval_geo",
                     "sgaligner_tpu_torch.reg.synthetic_pairs",
                     "sgaligner_tpu_torch.cli.inference_find_overlapper",
                     "sgaligner_tpu_torch.cli.inference_mosaicking"):
        assert expected in names


def _targets(target):
    return {"package": _port_modules(), "chip_smoke": ["chip_smoke"],
            "export_script": [EXPORT_SCRIPT]}[target]


@pytest.mark.parametrize("target", ["package", "chip_smoke", "export_script"])
def test_no_jax_imported(target):
    assert _imported_banned(_targets(target)) == []


@pytest.mark.parametrize("target", ["package", "chip_smoke", "export_script"])
def test_no_yaml_or_tensorstore_at_import(target):
    assert _imported_banned(_targets(target), HOST_ONLY) == []


_QUALITY_WITHOUT_HOST_ONLY = r"""
import json, sys, tempfile
for name in ("yaml", "tensorstore"):
    sys.modules[name] = None                 # importing either now raises
import chip_smoke
with tempfile.TemporaryDirectory() as root:
    chip_smoke.build_val_workspace(root, chip_smoke.snapshot_quality("eva"))
    results, times, c3, _ = chip_smoke.quality_run("eva", root, "cpu")
print(json.dumps({"mrr": results["mrr"], "c3": c3, "requests": len(times)}))
"""


def test_quality_path_needs_neither_yaml_nor_tensorstore():
    """chip_smoke.py's quality run of one snapshot (EVA), on the CPU, with
    PyYAML and tensorstore unimportable."""
    out = subprocess.run([sys.executable, "-c", _QUALITY_WITHOUT_HOST_ONLY],
                         cwd=REPO, env=_env(), capture_output=True, text=True,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["c3"] == 200 and got["requests"] == 4
    import chip_smoke

    pinned = chip_smoke.snapshot_quality("eva")["results"]["mrr"]
    assert abs(got["mrr"] - pinned) <= chip_smoke.QUALITY_ABS


_TRAINER_WITHOUT_HOST_ONLY = r"""
import json, sys, tempfile
# importing any of these now raises (the Trainer then writes no events)
for name in ("yaml", "tensorstore", "torch.utils.tensorboard"):
    sys.modules[name] = None
import chip_smoke
from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
with tempfile.TemporaryDirectory() as root:
    for split, seed, n in (("train", 1, 8), ("val", 2, 4)):
        make_synthetic_workspace(root, split=split, n_pairs=n, seed=seed, n_shared=4,
                                 n_extra=3, pts_per_obj=48, pc_resolutions=[32])
    cfg = chip_smoke.train_cfg(root, root + "/out", chip_smoke.EVA_RECIPE["modules"], "eva")
    cfg.tpu.max_objects, cfg.tpu.points_per_object = 8, 32
    cfg.train.pc_res = cfg.val.pc_res = 32
    cfg.preprocess.pc_resolutions = [32]
    run = chip_smoke.retrain(cfg, (1, 2), "cpu")
print(json.dumps({"mrr": run["results"]["mrr"], "iteration": run["iteration"],
                  "epochs": [h["epochs"] for h in run["history"]],
                  "snapshot": run["snapshot"].rsplit("/", 1)[-1]}))
"""


def test_trainer_path_needs_neither_yaml_nor_tensorstore():
    """chip_smoke.py's retrain (trainval_eva's train function, a resumed
    Trainer, the tester) on a tiny workspace on the CPU, the config a dict,
    with PyYAML and tensorstore unimportable (and TensorBoard's writer,
    whose tensorflow import, where installed, would take most of the
    test's time)."""
    out = subprocess.run([sys.executable, "-c", _TRAINER_WITHOUT_HOST_ONLY],
                         cwd=REPO, env=_env(), capture_output=True, text=True,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # 8 train pairs in batches of 8: one step an epoch
    assert got["iteration"] == 2 and got["epochs"] == [1, 2]
    assert got["snapshot"] == "best_snapshot.pth.tar" and 0.0 < got["mrr"] <= 1.0


def test_probe_matches_the_jax_package_exactly():
    """The probe would see the JAX package itself (and only by exact name):
    importing its jax-free config module is reported."""
    assert _imported_banned(["sgaligner_tpu.core.config"]) == [
        "sgaligner_tpu", "sgaligner_tpu.core", "sgaligner_tpu.core.config"]
