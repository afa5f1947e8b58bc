"""The port's snapshot reader, the committed ``.pth.tar`` copies and the
quality contract, against the JAX package, on the CPU.

* ``read_ocdbt_snapshot`` (tensorstore, no JAX) gives the same arrays as
  the JAX package's orbax ``load_snapshot`` for every aligner snapshot under
  ``checkpoints/``, array-equal, with the same epoch and iteration;
* each ``checkpoints/torch/aligner_<name>.pth.tar`` equals
  ``state_dict_from_flax`` of the reader's model tree, array-equal, and the
  JAX package's ``torch_state_dict_to_params`` of it gives back the store's
  model tree (the parity-mode PointNet has no BatchNorm statistics, so
  nothing is excepted);
* the copy of the benchmark contract in ``chip_smoke.py`` equals
  ``scripts/aligner_artifact.py``'s constants, the values its ``write_cfg``
  writes, and each ``quality.json``.
"""

import importlib.util
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import jax

from sgaligner_tpu.core.checkpoint import load_snapshot, torch_state_dict_to_params
from sgaligner_tpu_torch.core import checkpoint as port_ckpt

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ALL_SNAPSHOTS = ("point", "full", "eva", "ablation")

_spec = importlib.util.spec_from_file_location(
    "aligner_artifact", osp.join(REPO, "scripts", "aligner_artifact.py"))
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert g[k].dtype == w[k].dtype, f"{what}{k}"
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}{k}")


@pytest.mark.parametrize("name", ALL_SNAPSHOTS)
def test_reader_matches_orbax(name):
    path = osp.join(REPO, "checkpoints", f"aligner_{name}")
    got = port_ckpt.read_ocdbt_snapshot(path)
    want = load_snapshot(path)
    assert (got["epoch"], got["iteration"]) == (want["epoch"], want["iteration"])
    trees = sorted(k for k in want if k not in ("epoch", "iteration"))
    assert sorted(k for k in got if k not in ("epoch", "iteration")) == trees
    for key in trees:
        _assert_trees_equal(got[key], want[key], f"{name}:{key}")
    assert "model" in got["params"] and "loss" in got["params"]


@pytest.mark.parametrize("name", smoke.SNAPSHOTS)
def test_torch_copy_matches_the_store(name):
    store = port_ckpt.read_ocdbt_snapshot(
        osp.join(REPO, "checkpoints", f"aligner_{name}"))
    modules = tuple(smoke.snapshot_quality(name)["modules"])
    want = port_ckpt.state_dict_from_flax(store["params"]["model"],
                                          store.get("batch_stats"), modules)
    blob = port_ckpt.load_torch_snapshot(smoke.torch_snapshot(name))
    assert (blob["epoch"], blob["iteration"]) == (store["epoch"], store["iteration"])
    assert sorted(blob["model"]) == sorted(want)
    for k, v in want.items():
        assert blob["model"][k].dtype == v.dtype, k
        assert torch.equal(blob["model"][k], v), k
    # the JAX package's import of the copy gives back the store's tree
    heads = (2, 2)
    params, stats = torch_state_dict_to_params(blob["model"], modules, heads)
    _assert_trees_equal(params, store["params"]["model"], f"{name}:params")
    assert stats == {} and "batch_stats" not in store
    if name == "eva":
        assert blob["model"]["object_encoder.conv3.weight"].shape == (200, 128, 1)
        assert blob["model"]["structure_encoder.layer_stack.1.lin.weight"].shape == (400, 200)


def test_torch_snapshot_layout(tmp_path):
    """save_torch_snapshot writes upstream's {"model", "epoch",
    "iteration"}; load_torch_snapshot takes it, a bare state_dict and DDP's
    "module." prefix, as the JAX package's loader does."""
    sd = {"fusion.weight": torch.arange(4.0).reshape(4, 1)}
    path = port_ckpt.save_torch_snapshot(str(tmp_path / "a.pth.tar"), sd, 3, 7)
    blob = torch.load(path, weights_only=True)
    assert sorted(blob) == ["epoch", "iteration", "model"]
    got = port_ckpt.load_torch_snapshot(path)
    assert (got["epoch"], got["iteration"]) == (3, 7)
    assert torch.equal(got["model"]["fusion.weight"], sd["fusion.weight"])
    torch.save({"module.fusion.weight": sd["fusion.weight"]}, tmp_path / "b.pth")
    bare = port_ckpt.load_torch_snapshot(str(tmp_path / "b.pth"))
    assert list(bare["model"]) == ["fusion.weight"] and bare["epoch"] == 0
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_torch_snapshot(str(tmp_path / "missing.pth.tar"))


def test_reader_without_tensorstore_names_the_copies(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="pth.tar"):
        port_ckpt.read_ocdbt_snapshot(osp.join(REPO, "checkpoints", "aligner_point"))


@pytest.mark.parametrize("name", smoke.SNAPSHOTS)
def test_contract_matches_the_script_and_quality(name, tmp_path):
    import yaml

    assert smoke.BENCH == script.BENCH
    assert (smoke.VAL_SEED, smoke.N_VAL_PAIRS, smoke.MAX_EPOCH) == (
        script.VAL_SEED, script.N_VAL_PAIRS, script.MAX_EPOCH)
    # the trainer phase's retrain: the script's train split and EVA recipe,
    # whose config is the tester's (quality_cfg's values)
    assert (smoke.TRAIN_SEED, smoke.N_TRAIN_PAIRS) == (script.TRAIN_SEED,
                                                       script.N_TRAIN_PAIRS)
    assert smoke.EVA_RECIPE == script.CONFIGS["eva"]
    q = smoke.snapshot_quality(name)
    assert q["bench"] == smoke.BENCH
    assert (q["val_seed"], q["n_val_pairs"]) == (smoke.VAL_SEED, smoke.N_VAL_PAIRS)
    model_name = q.get("model_name", "sgaligner")
    root = str(tmp_path / "ws")
    written = script.write_cfg(str(tmp_path / "cfg.yaml"), root, q["modules"],
                               model_name=model_name)
    with open(written) as f:
        want = yaml.safe_load(f)
    assert smoke.quality_cfg(root, q["modules"], model_name) == want
    if name == "eva":
        # the config the script trains EVA with
        rec = script.CONFIGS["eva"]
        trained = script.write_cfg(str(tmp_path / "train.yaml"), root, rec["modules"],
                                   max_epoch=rec["epochs"], model_name=rec["model_name"],
                                   scheduler=rec["scheduler"], lr=rec["lr"])
        with open(trained) as f:
            want = yaml.safe_load(f)
        assert smoke.quality_cfg(root, smoke.EVA_RECIPE["modules"], "eva") == want
