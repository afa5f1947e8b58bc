"""The port's library API (sgaligner_tpu_torch/api.py) and its CLIs
(demo_align, export_serving, inference_align_reg with registration), on
the CPU.

``Aligner.align_arrays`` is held to the JAX package's ``api.Aligner`` at
float64, the JAX object's weights set from the port's through
``torch_state_dict_to_params``: the same node matches and alignment score,
the similarity matrix within 1e-9. ``align(register=True)`` recovers the
identity between two scenes of one synthetic workspace (the JAX
tests/test_api.py bounds: RRE < 5 degrees, RTE < 0.1). Each CLI runs once
with ``--device cpu`` on a tiny workspace.
"""

import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu_torch import api
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
from sgaligner_tpu_torch.reg.metrics import compute_registration_error
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)


def _objects(rng):
    """Four shared objects and two extra on the ref side (the JAX
    tests/test_api.py case)."""
    shared = rng.normal(0, 0.3, size=(4, 64, 3)).astype(np.float32)
    centers = rng.uniform(-2, 2, size=(4, 3)).astype(np.float32)
    src = shared + centers[:, None]
    ref = np.concatenate([shared + centers[:, None],
                          rng.normal(0, 0.3, size=(2, 64, 3)).astype(np.float32)])
    return src, ref


def test_align_arrays_matches_jax_f64(x64):
    from sgaligner_tpu import api as japi
    from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
    from sgaligner_tpu.core.config import make_cfg as jmake_cfg
    from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder

    cfg = make_cfg(model_name="sgaligner", modules=["point"])
    cfg.tpu.compute_dtype = "float64"
    aligner = api.Aligner(cfg, device="cpu")
    src, ref = _objects(np.random.default_rng(0))
    ids = dict(src_obj_ids=np.arange(1, 5), ref_obj_ids=np.arange(1, 7))
    got = aligner.align_arrays(src, ref, **ids)

    jal = japi.Aligner(jmake_cfg(model_name="sgaligner", modules=["point"]))
    params, stats = torch_state_dict_to_params(
        {k: v.cpu() for k, v in aligner.model.state_dict().items()}, ("point",))
    jal.params = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
    jal.batch_stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)
    jal.model = JaxEncoder(modules=("point",), pointnet_fused="never", dtype=jnp.float64)
    want = jal.align_arrays(src, ref, **ids)

    assert got.node_matches == want.node_matches
    assert dict(got.node_matches) == {1: 1, 2: 2, 3: 3, 4: 4}
    assert (got.n_src, got.n_ref) == (want.n_src, want.n_ref) == (4, 6)
    assert want.sim.dtype == np.float64
    np.testing.assert_allclose(got.sim, want.sim, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.alignment_score, want.alignment_score, rtol=1e-9)


def test_align_with_registration_recovers_identity(tmp_path):
    make_synthetic_workspace(str(tmp_path), split="val", n_pairs=1, pts_per_obj=150)
    cfg = make_cfg(model_name="sgaligner", modules=["point"])
    cfg.preprocess.min_obj_points = 50
    cfg.val.pc_res = 64
    cfg.reg_model.ransac_max_iters = 200
    aligner = api.load_aligner(cfg, device="cpu")
    res = aligner.align(str(tmp_path / "scans" / "scene00_src" / "data.npy"),
                        str(tmp_path / "scans" / "scene00_ref" / "data.npy"),
                        register=True)
    assert res.transform is not None and res.node_matches
    rre, rte = compute_registration_error(np.eye(4), res.transform)
    assert rre < 5.0 and rte < 0.1, (rre, rte)


def _workspace_cfg(tmp_path, **extra) -> str:
    """A one-pair val workspace and its YAML config (point modules)."""
    import yaml

    root = str(tmp_path / "ws")
    make_synthetic_workspace(root, split="val", n_pairs=1, pts_per_obj=150)
    values = dict(model_name="sgaligner", modules=["point", "gat", "rel", "attr"],
                  data={"subscan_dir": root},
                  preprocess={"pc_resolutions": [64], "min_obj_points": 50},
                  val={"batch_size": 1, "pc_res": 64},
                  tpu={"max_objects": 16, "points_per_object": 64}, **extra)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(values, f)
    return path


def test_clis_run_on_cpu(tmp_path, capsys):
    """demo_align, export_serving and inference_align_reg with registration,
    each once with --device cpu."""
    from sgaligner_tpu_torch.cli import demo_align, export_serving, inference_align_reg
    from sgaligner_tpu_torch.core.checkpoint import save_torch_snapshot
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.serving import load_serving_artifact

    cfg_path = _workspace_cfg(tmp_path, registration=True,
                              reg_model={"ransac_max_iters": 200})
    scans = tmp_path / "ws" / "scans"
    assert demo_align.main(["--src", str(scans / "scene00_src" / "data.npy"),
                            "--ref", str(scans / "scene00_ref" / "data.npy"),
                            "--pc_res", "64", "--device", "cpu"]) == 0
    demo = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert demo["src_objects"] > 0 and demo["node_matches(src_obj_id -> ref_obj_id)"]

    cfg = make_cfg(modules=["point", "gat", "rel", "attr"])
    cfg.tpu.max_objects, cfg.tpu.points_per_object = 16, 64
    snap = str(tmp_path / "snap.pth.tar")
    save_torch_snapshot(snap, build_model(cfg, "cpu", torch.Generator().manual_seed(1)
                                          ).state_dict())
    out_root = str(tmp_path / "out")
    assert export_serving.main(["--config", cfg_path, "--snapshot", snap, "--out",
                                str(tmp_path / "art"), "--batch", "2",
                                "--pooled_bucket", "16", "--device", "cpu",
                                "--output_root", out_root]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["batch_size"] == 2
    art = load_serving_artifact(str(tmp_path / "art"), device="cpu")
    assert art.meta["pooled_k"] == 16 and art.meta["device"] == "cpu"

    assert inference_align_reg.main(["--config", cfg_path, "--snapshot", snap,
                                     "--device", "cpu", "--output_root", out_root]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for kind in ("normal_registration", "aligner_registration"):
        assert set(results[kind]) == {"CD", "IR", "RRE", "RTE", "recall", "FMR"}, kind
    assert results["aligner_registration"]["RRE"] < 5.0
