"""The port's registration stack against the JAX package's, on the CPU.

RANSAC: the port draws its minimal sets on a CPU generator
(``reg.ransac.draw_minimal_sets``); these tests inject the JAX package's
own draw (Gumbel top-k over the padded bucket, ``sgaligner_tpu/reg/
ransac.py``) so both sides score the same hypotheses. Under JAX x64:
``ransac_hypotheses`` at float64 (transforms to 1e-9, equal scores) and the
winner's refinement, which the JAX ``ransac_rigid_transform`` cannot run at
float64 (its scan carry starts as float32), held to the JAX ``kabsch``
applied to the JAX hypotheses (``jax_fit_f64``). The port's host wrappers
fit at float64: ``find_rigid_transform`` is held to ``jax_fit_f64`` at
1e-9 and, like the port's device functions on float32 inputs, to the JAX
function's float32 fit at 1e-5. The backend, the evaluator and the tester run the JAX package with
``jax_fit_f64`` in place of its float32 fit (at float32 the rotation error
alone, arccos near 0, moves by 1e-2 degrees between two roundings). ICP
computes at float32 on both sides whatever the input (the JAX function
casts). The numpy stages are array-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.reg import ransac as jransac
from sgaligner_tpu.reg.kabsch_test_helpers import random_transform
from sgaligner_tpu_torch.reg import ransac
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)


def jax_draw(n_valid: int, iters: int, seed: int) -> torch.Tensor:
    """The JAX package's minimal sets for a valid prefix of ``n_valid`` in
    ``find_rigid_transform``'s bucket (ransac.py:69-70)."""
    bucket = 1 << max(int(np.ceil(np.log2(n_valid))), 6)
    mask = jnp.arange(bucket) < n_valid
    g = jax.random.gumbel(jax.random.key(seed), (iters, bucket)) \
        + jnp.where(mask, 0.0, -1e30)[None]
    _, samples = jax.lax.top_k(g, 3)
    return torch.from_numpy(np.asarray(samples).astype(np.int64))


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(ransac, "draw_minimal_sets", jax_draw)


def jax_fit_f64(src_corr, ref_corr, threshold=0.03, max_iters=5000, seed=0,
                max_corrs=20000):
    """The JAX ``find_rigid_transform`` at float64 (under x64): its
    subsample and bucket, the JAX ``ransac_hypotheses``, then the first
    winner refined three times by the JAX ``kabsch`` on its inliers."""
    n = len(src_corr)
    if n < 3:
        return None, np.zeros(0, bool)
    if n > max_corrs:
        sel = np.random.default_rng(seed).choice(n, max_corrs, replace=False)
        src_corr, ref_corr = src_corr[sel], ref_corr[sel]
        n = max_corrs
    bucket = 1 << max(int(np.ceil(np.log2(n))), 6)
    src_p, ref_p = np.zeros((bucket, 3)), np.zeros((bucket, 3))
    src_p[:n], ref_p[:n] = src_corr, ref_corr
    src_j, ref_j = jnp.asarray(src_p), jnp.asarray(ref_p)
    mask = np.arange(bucket) < n
    maskf = jnp.asarray(mask, jnp.float64)
    tfs, scores = expect_dtype(jransac.ransac_hypotheses(
        src_j, ref_j, jnp.asarray(mask), jax.random.key(seed), threshold=threshold,
        iters=max_iters))
    best = tfs[int(np.argmax(np.asarray(scores)))]
    for _ in range(3):
        w = (jransac._residuals(src_j, ref_j, best) < threshold) * maskf
        if float(w.sum()) >= 3:
            best = jransac.kabsch(src_j, ref_j, w + 1e-12)
    tf = np.asarray(best, np.float64)
    res = np.linalg.norm(src_corr @ tf[:3, :3].T + tf[:3, 3] - ref_corr, axis=-1)
    return tf, res < threshold


@pytest.fixture
def jax_f64_fit(x64, injected, monkeypatch):
    """The JAX package's backend and evaluator fitting by ``jax_fit_f64``."""
    from sgaligner_tpu.reg import backend as jbackend
    from sgaligner_tpu.reg import evaluator as jevaluator

    monkeypatch.setattr(jbackend, "find_rigid_transform", jax_fit_f64)
    monkeypatch.setattr(jevaluator, "find_rigid_transform", jax_fit_f64)


def correspondences(rng, n, inliers=0.4, noise=0.003, dtype=np.float64):
    """Correspondences under a random rigid transform, the rest uniform."""
    tf = random_transform(rng, 60.0, 1.0)
    src = rng.uniform(-1, 1, size=(n, 3))
    ref = src @ tf[:3, :3].T + tf[:3, 3]
    out = rng.random(n) >= inliers
    ref[out] = rng.uniform(-1, 1, size=(int(out.sum()), 3)) + tf[:3, 3]
    ref[~out] += rng.normal(0, noise, size=(int((~out).sum()), 3))
    return src.astype(dtype), ref.astype(dtype), tf


def test_ransac_f64_matches_jax(x64, injected):
    rng = np.random.default_rng(0)
    n, bucket, iters, seed, thr = 100, 128, 300, 4, 0.03
    src, ref, _ = correspondences(rng, n)
    src_p, ref_p = np.zeros((bucket, 3)), np.zeros((bucket, 3))
    src_p[:n], ref_p[:n] = src, ref
    mask = np.arange(bucket) < n

    jtfs, jscores = expect_dtype(jransac.ransac_hypotheses(
        jnp.asarray(src_p), jnp.asarray(ref_p), jnp.asarray(mask),
        jax.random.key(seed), threshold=thr, iters=iters))
    tp = [torch.from_numpy(a) for a in (src_p, ref_p, mask)]
    tfs, scores = ransac.ransac_hypotheses(*tp, seed, threshold=thr, iters=iters)
    assert tfs.dtype == torch.float64
    np.testing.assert_allclose(tfs.numpy(), np.asarray(jtfs), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))

    # the winner (first of the highest count) refined three times by the
    # JAX kabsch on its inliers, as the JAX ransac_rigid_transform does
    want, want_in = jax_fit_f64(src, ref, threshold=thr, max_iters=iters, seed=seed)
    tf, n_in = ransac.ransac_rigid_transform(*tp, seed, threshold=thr, iters=iters)
    np.testing.assert_allclose(tf.numpy(), want, rtol=0, atol=1e-9)
    assert float(n_in) == want_in.sum() > 0.3 * n
    got, got_in = ransac.find_rigid_transform(src, ref, threshold=thr, max_iters=iters,
                                              seed=seed, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got_in, want_in)


def port_fit_f32(src_corr, ref_corr, threshold=0.03, max_iters=5000, seed=0):
    """The port's ``find_rigid_transform`` with its buffers cast to float32,
    as the JAX package fits: the device functions follow their inputs'
    dtype."""
    src_p, ref_p, mask = ransac._padded(src_corr, ref_corr, "cpu")
    tf, _ = ransac.ransac_rigid_transform(src_p.float(), ref_p.float(), mask, seed,
                                          threshold=threshold, iters=max_iters)
    tf = tf.numpy().astype(np.float64)
    res = np.linalg.norm(src_corr @ tf[:3, :3].T + tf[:3, 3] - ref_corr, axis=-1)
    return tf, res < threshold


def test_find_rigid_transform_f32_matches_jax(injected):
    """The JAX float32 fit: the port's device functions at float32, and its
    float64 host wrappers, each within 1e-5."""
    rng = np.random.default_rng(1)
    src, ref, tf_true = correspondences(rng, 500, dtype=np.float32)
    want, want_in = jransac.find_rigid_transform(src, ref, max_iters=300, seed=2)
    for got, got_in in (port_fit_f32(src, ref, max_iters=300, seed=2),
                        ransac.find_rigid_transform(src, ref, max_iters=300, seed=2,
                                                    device="cpu")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_in, want_in)
        np.testing.assert_allclose(got, tf_true, atol=1e-2)
    # more than max_corrs: the same host subsample on both sides
    want, _ = jransac.find_rigid_transform(src, ref, max_iters=300, seed=2,
                                           max_corrs=200)
    got, _ = ransac.find_rigid_transform(src, ref, max_iters=300, seed=2,
                                         max_corrs=200, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the top-k of distinct consensus clusters: two planted transforms
    src2, ref2, tf2 = correspondences(rng, 300, dtype=np.float32)
    src_k, ref_k = np.concatenate([src, src2]), np.concatenate([ref, ref2])
    want = jransac.find_rigid_transforms_topk(src_k, ref_k, k=2, max_iters=300, seed=2)
    got = ransac.find_rigid_transforms_topk(src_k, ref_k, k=2, max_iters=300, seed=2,
                                            device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_draw_is_uniform_over_distinct_triples():
    s = ransac.draw_minimal_sets(5, 20000, seed=0)
    assert s.shape == (20000, 3) and s.dtype == torch.int64
    assert bool(((s[:, 0] != s[:, 1]) & (s[:, 0] != s[:, 2])
                 & (s[:, 1] != s[:, 2])).all())
    # 60 ordered triples of 5, each drawn about 20000 / 60 = 333 times
    counts = np.bincount((s[:, 0] * 25 + s[:, 1] * 5 + s[:, 2]).numpy(), minlength=125)
    assert (counts > 0).sum() == 60 and counts.max() < 1.5 * counts[counts > 0].min()
    assert torch.equal(s, ransac.draw_minimal_sets(5, 20000, seed=0))


def test_icp_matches_jax():
    from sgaligner_tpu.reg import icp as jicp
    from sgaligner_tpu_torch.reg import icp

    rng = np.random.default_rng(3)
    cloud = rng.uniform(-1, 1, size=(300, 3))
    tf = random_transform(rng, 5.0, 0.05)
    moved = cloud @ tf[:3, :3].T + tf[:3, 3]
    want, want_rmse = jicp.icp_refine_host(cloud, moved, iters=8, max_corr_dist=0.3,
                                           max_points=256, seed=1)
    got, got_rmse = icp.icp_refine_host(cloud, moved, iters=8, max_corr_dist=0.3,
                                        max_points=256, seed=1, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_rmse, want_rmse, rtol=0, atol=1e-6)


def test_numpy_stages_array_equal():
    from sgaligner_tpu.reg import backend as jbackend
    from sgaligner_tpu.reg import coarse as jcoarse
    from sgaligner_tpu.reg import metrics as jmetrics
    from sgaligner_tpu.utils import pointcloud as jpc
    from sgaligner_tpu_torch.reg import backend, coarse, metrics
    from sgaligner_tpu_torch.utils import pointcloud as pc

    rng = np.random.default_rng(5)
    a = (rng.normal(size=(400, 3)) * [0.5, 0.2, 0.1]).astype(np.float32)
    tf = random_transform(rng, 45.0, 0.5)
    b = pc.apply_transform(a, tf).astype(np.float32)
    np.testing.assert_array_equal(coarse.pca_coarse_align(a, b, seed=3),
                                  jcoarse.pca_coarse_align(a, b, seed=3))
    np.testing.assert_array_equal(backend.voxel_downsample(a, 0.05),
                                  jbackend.voxel_downsample(a, 0.05))
    shared = np.concatenate([a[:150], rng.normal(size=(50, 3)).astype(np.float32)])
    for got, want in zip(pc.compute_pcl_overlap(shared, a), jpc.compute_pcl_overlap(shared, a)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pc.get_nearest_neighbor(b, a, return_index=True),
                         jpc.get_nearest_neighbor(b, a, return_index=True)):
        np.testing.assert_array_equal(got, want)
    est = random_transform(rng, 2.0, 0.02)
    for name, args in (
            ("compute_modified_chamfer_distance", (a, b, np.concatenate([a, b]), est, tf)),
            ("compute_inlier_ratio", (b, a, est)),
            ("compute_registration_rmse", (b, a, est)),
            ("compute_registration_error", (tf, est)),
            ("compute_mosaicking_error", (a, b[:300]))):
        got, want = getattr(metrics, name)(*args), getattr(jmetrics, name)(*args)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            got, want = list(got.values()), list(want.values())
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def _pair(rng, identity: bool):
    """Two objects with anisotropic geometry, the ref side under a 45 deg /
    0.5 m transform (or the identity): the setting of
    tests/test_registration_nonidentity.py."""
    from sgaligner_tpu_torch.utils.io import make_ply_npy

    pts, oids = [], []
    for i in (1, 2):
        scale = np.array([0.5, 0.25, 0.1]) * (1.0 + 0.3 * rng.random(3))
        axes, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pts.append(rng.normal(size=(200, 3)) * scale @ axes.T + rng.uniform(-3, 3, size=3))
        oids.append(np.full(200, i))
    src = np.concatenate(pts).astype(np.float32)
    oids = np.concatenate(oids)
    gt = np.eye(4) if identity else random_transform(rng, 45.0, 0.5)
    ref = (src @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
    return {"node_corrs": [(1, 1), (2, 2)], "src_points": src, "ref_points": ref,
            "src_plydata": make_ply_npy(src, oids), "ref_plydata": make_ply_npy(ref, oids),
            "raw_points": np.concatenate([src, ref]), "gt_transform": gt,
            "gt_src_corr_points": src, "gt_ref_corr_points": ref}


def test_backend_and_evaluator_match_jax(jax_f64_fit):
    """At the identity and off it (45 deg / 0.5 m, the PCA coarse start)."""
    from sgaligner_tpu.core.config import make_cfg as jmake_cfg
    from sgaligner_tpu.reg.backend import MutualNNBackend as JBackend
    from sgaligner_tpu.reg.evaluator import RegistrationEvaluator as JEvaluator
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.reg.backend import MutualNNBackend
    from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator

    for identity in (True, False):
        reg = _pair(np.random.default_rng(7 if identity else 8), identity)
        coarse = "none" if identity else "pca"
        kw = dict(coarse=coarse, ransac_iters=300)
        want = JBackend(**kw).register(reg["src_points"], reg["ref_points"])
        got = MutualNNBackend(**kw, device="cpu").register(reg["src_points"],
                                                           reg["ref_points"])
        for k in ("src_corr_points", "ref_corr_points", "corr_scores"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["estimated_transform"],
                                   want["estimated_transform"], rtol=0, atol=1e-9)

        cfgs = []
        for make in (jmake_cfg, make_cfg):
            cfg = make(model_name="sgaligner", modules=["point"])
            cfg.reg_model.ransac_max_iters = 300
            cfg.reg_model.coarse = coarse
            cfgs.append(cfg)
        want = JEvaluator(cfgs[0], JBackend(**kw)).run_registration(reg)
        got = RegistrationEvaluator(cfgs[1], MutualNNBackend(**kw, device="cpu")
                                    ).run_registration(reg)
        _summaries_close(dict(zip(("normal", "aligner"), got)),
                         dict(zip(("normal", "aligner"), want)))
        assert got[1]["RRE"] < 1.0 and got[1]["RTE"] < 0.03


# the rotation error reads arccos((tr R - 1) / 2) in degrees: near the
# identity one float64 rounding of the trace moves it by up to
# 180/pi * sqrt(2 * 2.2e-16) = 1.2e-6 degrees
RRE_FLOOR = 2e-6


def _summaries_close(got: dict, want: dict, atol: float = 1e-6) -> None:
    for kind in want:
        assert got[kind].keys() == want[kind].keys() and got[kind], kind
        for k in want[kind]:
            np.testing.assert_allclose(got[kind][k], want[kind][k], rtol=0,
                                       atol=atol + (RRE_FLOOR if k == "RRE" else 0.0),
                                       err_msg=f"{kind} {k}")


def test_tester_registration_matches_jax(tmp_path, jax_f64_fit):
    """AlignRegTester with registration on a one-pair workspace against the
    JAX tester: the alignment metrics and both registration summaries."""
    from sgaligner_tpu.core.config import make_cfg as jmake_cfg
    from sgaligner_tpu.data.fixtures import make_synthetic_workspace
    from sgaligner_tpu.data.loaders import get_val_dataloader as jloader
    from sgaligner_tpu.engine.tester import AlignRegTester as JTester
    from sgaligner_tpu.reg.backend import build_backend as jbuild
    from sgaligner_tpu.reg.evaluator import RegistrationEvaluator as JEvaluator
    from sgaligner_tpu_torch.core.checkpoint import save_torch_snapshot
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.data.loaders import get_val_dataloader
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.engine.tester import AlignRegTester
    from sgaligner_tpu_torch.reg.backend import build_backend
    from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator

    root = str(tmp_path / "ws")
    make_synthetic_workspace(root, split="val", n_pairs=1, pts_per_obj=150)
    values = dict(model_name="sgaligner", modules=["point"], registration=True,
                  data={"subscan_dir": root},
                  preprocess={"pc_resolutions": [64], "min_obj_points": 50},
                  val={"batch_size": 1, "pc_res": 64},
                  tpu={"max_objects": 16, "points_per_object": 64},
                  reg_model={"ransac_max_iters": 200})
    cfg = make_cfg(**values)
    snap = str(tmp_path / "snap.pth.tar")
    save_torch_snapshot(snap, build_model(cfg, "cpu").state_dict())
    loader = get_val_dataloader(cfg)
    got = AlignRegTester(cfg, loader.dataset, loader,
                         registration_evaluator=RegistrationEvaluator(
                             cfg, build_backend(cfg, device="cpu")),
                         snapshot=snap, device="cpu").run()

    jcfg = jmake_cfg(**values)
    jl = jloader(jcfg)
    want = JTester(jcfg, jl.dataset, jl, registration_evaluator=JEvaluator(jcfg, jbuild(jcfg)),
                   snapshot=snap).run()
    kinds = ("normal_registration", "aligner_registration")
    _summaries_close({k: got[k] for k in kinds}, {k: want[k] for k in kinds})
    for k in ("mrr", "hits@1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
