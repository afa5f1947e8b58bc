"""The port's learned registration backend against the JAX package's, on
the CPU.

* ``reg/synthetic_pairs.py``: array-equal to the original for the seeds
  and kinds the JAX tests use.
* FPS (``ops/fps.py``): equal indices, ties and masks included.
* ``sinkhorn_log``, ``fine_log_assign`` and ``GeoRegModel`` at float64
  under JAX x64, a tiny configuration with parameters built from a seed and
  carried across by ``geo_state_dict_from_flax``: within 1e-9 normwise.
* The tracked ``geo_reg`` weights at float32 on one synthetic pair (S =
  128, M = 32): the same model inputs, outputs within 1e-4 normwise and the
  same superpoint correspondences. ``checkpoints/torch/geo_reg.pth.tar``
  equal to the orbax tree key by key, and ``geo_meta.json`` read.
* The host functions (``patch_invariants``, the two correspondence
  extractions, ``weighted_kabsch``) array-equal on the same inputs.
* ``ransac_hypotheses_batch`` (JAX draws injected; a minimal set with a
  repeated point the identity and score 0) and
  ``icp_refine_stages_batch`` against the JAX functions, and
  ``LearnedBackend.register_batch`` on 4 pairs with retries, the tracked
  weights at float32 (the port fits at float64, the JAX package at
  float32) with the JAX draws injected: the same rounds and
  declined pairs, equal correspondence counts, transforms within 1e-4 and
  ``fit_score`` within 1e-5. ``eval_geo``'s sweeps on the same replayed
  registrations: equal aggregates.

The port draws its RANSAC sets on a CPU generator from each set's identity
(``reg.ransac.draw_instance_sets``); ``jax_instance_draw`` is the JAX
package's draw for the same identity (Gumbel top-k over the round's padded
bucket, keyed by ``fold_in`` on (seed, pair id, role)).
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.reg import geo_model as jgeo
from sgaligner_tpu.reg import learned as jlearned
from sgaligner_tpu_torch.core.checkpoint import geo_state_dict_from_flax
from sgaligner_tpu_torch.reg import geo_model, learned, ransac
from tests.test_torch_ops import expect_dtype, to_jax, x64  # noqa: F401  (fixture)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GEO_DIR = osp.join(REPO, "checkpoints", "geo_reg")
TINY = dict(dim=32, point_dim=16, heads=2, blocks=1, sinkhorn_iters=10)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs six workers on
    the host's cores, and the CPU matcher and ICP would take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def jax_instance_draw(seed, pair_id, role, n_valid, bucket, iters):
    """The JAX package's minimal sets for one correspondence set of
    ``register_round`` (learned_batch.py:272-305)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(np.uint32(seed)),
                                                pair_id), role)
    mask = jnp.arange(bucket) < n_valid
    g = jax.random.gumbel(key, (iters, bucket)) + jnp.where(mask, 0.0, -1e30)[None]
    return torch.from_numpy(np.asarray(jax.lax.top_k(g, 3)[1]).astype(np.int64))


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(ransac, "draw_instance_sets", jax_instance_draw)


# ------------------------------ synthetic pairs -----------------------------

def test_synthetic_pairs_equal_the_original():
    from sgaligner_tpu.reg import synthetic_pairs as jsp
    from sgaligner_tpu_torch.reg import synthetic_pairs as sp

    def both(fn, seed, *args, **kw):
        return (getattr(sp, fn)(np.random.default_rng(seed), *args, **kw),
                getattr(jsp, fn)(np.random.default_rng(seed), *args, **kw))

    cases = [both("make_pair", 321, n_points=2048, overlap=0.6),
             both("make_pair", (999, 20, 3), n_points=2048, overlap=0.2,
                  return_scene=True),
             both("make_pair", (424_242, 30, 5), n_points=2048, overlap=0.3,
                  return_scene=True, kind="room"),
             both("make_pair", 7, n_points=1024, overlap=0.5, kind="mix+rough"),
             both("random_rigid", 3, 90.0, 0.5)]
    cloud = np.random.default_rng(0).uniform(-2, 2, size=(3000, 3)).astype(np.float32)
    cases.append(both("make_pair_from_cloud", 11, cloud, overlap=0.4, return_scene=True))
    for got, want in cases:
        got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# ----------------------------------- FPS -----------------------------------

def test_fps_indices_equal_jax():
    from sgaligner_tpu.ops.fps import farthest_point_sample as jfps
    from sgaligner_tpu_torch.ops.fps import farthest_point_sample, fps_sample

    rng = np.random.default_rng(4)
    b, n, npoint = 4, 96, 24
    pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    pts[1, 40:] = pts[1, :56]                   # duplicated points: tied distances
    pts[2] = np.round(pts[2])                   # a lattice: many ties
    mask = np.ones((b, n), bool)
    mask[0, 70:] = False
    mask[3, 5:] = False                         # fewer valid points than picks
    starts = np.array([0, 3, 17, 2], np.int32)
    want = np.asarray(jfps(jnp.asarray(pts), npoint, start_idx=jnp.asarray(starts),
                           mask=jnp.asarray(mask)))
    got = farthest_point_sample(torch.from_numpy(pts), npoint,
                                start_idx=torch.from_numpy(starts).long(),
                                mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    got0 = farthest_point_sample(torch.from_numpy(pts), npoint)
    np.testing.assert_array_equal(got0.numpy(), np.asarray(jfps(jnp.asarray(pts), npoint)))
    np.testing.assert_array_equal(fps_sample(torch.from_numpy(pts), npoint).numpy(),
                                  np.take_along_axis(pts, got0.numpy()[..., None], 1))


# ------------------------------ model at f64 --------------------------------

def _model_inputs(rng, b, s, m, valid_sp, valid_pts):
    """B pairs of matcher inputs: superpoint i valid for i < valid_sp[b],
    patch point j valid for j < valid_pts."""
    def side():
        sp = rng.normal(size=(b, s, 3))
        inv = np.abs(rng.normal(size=(b, s, m, 3)))
        eig = np.abs(rng.normal(size=(b, s, 3)))
        pmask = np.zeros((b, s, m), bool)
        pmask[:, :, :valid_pts] = True
        mask = np.arange(s)[None, :] < np.asarray(valid_sp)[:, None]
        pmask &= mask[..., None]
        return sp, inv, eig, pmask, mask

    src, ref = side(), side()
    return tuple(x for pair in zip(src, ref) for x in pair)


def _tiny_params(seed: int, dtype=np.float32):
    s, m = 8, 6
    args = [jnp.asarray(a[0]) for a in _model_inputs(np.random.default_rng(0), 1, s, m,
                                                     [s], m)]
    model = jgeo.GeoRegModel(jgeo.GeoModelConfig(**TINY))
    tree = jax.jit(model.init)(jax.random.key(seed), *args)["params"]
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _port_model(tree, dtype):
    model = geo_model.GeoRegModel(geo_model.GeoModelConfig(**TINY)).to(dtype)
    model.load_state_dict(geo_state_dict_from_flax(tree), strict=True)
    return model.eval()


def test_sinkhorn_and_fine_assign_match_jax_f64(x64):
    rng = np.random.default_rng(1)
    b, s, r = 3, 7, 5
    scores = rng.normal(size=(b, s, r)) * 3
    sm = rng.random((b, s)) < 0.7
    rm = rng.random((b, r)) < 0.7
    sm[:, 0] = rm[:, 0] = True
    sm[2] = False                               # a side with no valid row
    jsinkhorn = jax.jit(jgeo.sinkhorn_log, static_argnames="iters")
    want = np.stack([np.asarray(expect_dtype(jsinkhorn(
        *to_jax(scores[i]), jnp.asarray(sm[i]), jnp.asarray(rm[i]),
        *to_jax(np.float64(0.7)), iters=25))) for i in range(b)])
    got = geo_model.sinkhorn_log(torch.from_numpy(scores), torch.from_numpy(sm),
                                 torch.from_numpy(rm), torch.tensor(0.7, dtype=torch.float64),
                                 iters=25)
    assert got.dtype == torch.float64
    assert normwise(got.numpy(), want) < 1e-9

    s, m, d, k = 6, 5, 4, 3
    pf = [rng.normal(size=(b, s, m, d)) for _ in range(2)]
    pm = [rng.random((b, s, m)) < 0.8 for _ in range(2)]
    pairs = rng.integers(0, s, size=(b, k, 2)).astype(np.int32)
    jfine = jax.jit(jgeo.fine_log_assign, static_argnames="iters")
    want = np.stack([np.asarray(expect_dtype(jfine(
        *to_jax(pf[0][i], pf[1][i]), jnp.asarray(pm[0][i]), jnp.asarray(pm[1][i]),
        jnp.asarray(pairs[i]), *to_jax(np.float64(8.0), np.float64(1.5)), iters=15)))
        for i in range(b)])
    got = geo_model.fine_log_assign(*(torch.from_numpy(a) for a in (*pf, *pm, pairs)),
                                    torch.tensor(8.0, dtype=torch.float64),
                                    torch.tensor(1.5, dtype=torch.float64), iters=15)
    assert normwise(got.numpy(), want) < 1e-9


def test_geo_model_matches_jax_f64(x64):
    tree = _tiny_params(5, np.float64)
    rng = np.random.default_rng(2)
    b, s, m = 3, 12, 6
    # pair 1 has 4 valid superpoints (fewer than angle_k + 1 for some rows'
    # neighbours), pair 2 has 2; the padded rows' neighbours are ties at inf
    args = _model_inputs(rng, b, s, m, [s, 4, 2], 4)
    model = jgeo.GeoRegModel(jgeo.GeoModelConfig(**TINY))
    want = expect_dtype(jax.jit(jax.vmap(lambda *a: model.apply({"params": tree}, *a)))(
        *(jnp.asarray(a) for a in args)))
    port = _port_model(tree, torch.float64)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in args))
    assert sorted(got) == sorted(want)
    for key in ("log_assign", "src_feats", "ref_feats", "src_pf", "ref_pf"):
        assert got[key].dtype == torch.float64, key
        assert normwise(got[key].numpy(), np.asarray(want[key])) < 1e-9, key
    for key in ("fine_temp", "fine_alpha"):
        np.testing.assert_array_equal(np.broadcast_to(got[key].detach().numpy(), (b,)),
                                      np.asarray(want[key]))


# --------------------------- the tracked weights ----------------------------

@pytest.fixture(scope="module")
def tracked():
    """The tracked geo_reg tree (the JAX package's own orbax loader) and the
    port's copy."""
    from sgaligner_tpu.reg.train_geo import load_checkpoint

    tree = jax.tree.map(np.asarray, load_checkpoint(GEO_DIR))
    sd, meta = learned.load_geo_checkpoint(
        osp.join(REPO, "checkpoints", "torch", "geo_reg.pth.tar"))
    return tree, sd, meta


def test_weights_copy_equals_the_store(tracked):
    """checkpoints/torch/geo_reg.pth.tar against the orbax tree key by key;
    the loader reads geo_meta.json's cfg and prep, from the copy and from the
    JAX-package directory (tensorstore); the backend takes them up."""
    from sgaligner_tpu_torch.reg.backend import GEO_CHECKPOINT

    tree, sd, meta = tracked
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert len(flat) == len(sd) == 122
    for path, leaf in flat.items():
        parts = path.split("/")
        name = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
        got = sd[".".join(parts[:-1] + [name])].numpy()
        np.testing.assert_array_equal(got, leaf.T if parts[-1] == "kernel" else leaf,
                                      err_msg=path)
        assert got.dtype == np.float32
    with open(osp.join(GEO_DIR, "geo_meta.json")) as f:
        want_meta = json.load(f)
    assert meta == want_meta
    dir_sd, dir_meta = learned.load_geo_checkpoint(GEO_DIR)
    assert dir_meta == want_meta and sorted(dir_sd) == sorted(sd)
    for k in sd:
        assert torch.equal(dir_sd[k], sd[k]), k
    be = learned.LearnedBackend(GEO_CHECKPOINT, device="cpu")
    assert be.cfg == geo_model.GeoModelConfig(**want_meta["cfg"])
    assert (be.n_super, be.patch_m, be.voxel_size) == tuple(
        want_meta["prep"][k] for k in ("n_super", "patch_m", "voxel_size"))
    assert be.dtype == torch.float32


def test_tracked_weights_match_jax_f32(tracked):
    """One synthetic pair through both preparations and matchers at S = 128,
    M = 32: the same inputs, outputs within 1e-4 normwise, the same
    superpoint correspondences."""
    from sgaligner_tpu.reg.synthetic_pairs import make_pair

    tree, sd, meta = tracked
    prep = meta["prep"]
    src, ref, _ = make_pair(np.random.default_rng(321), n_points=2048, overlap=0.6)
    args = (prep["n_super"], prep["patch_m"], prep["voxel_size"], prep["max_points"])
    preps = []
    for pts in (src, ref):
        want = jlearned._prep_cloud(pts, *args, np.random.default_rng(0))
        got = learned._prep_cloud(pts, *args, np.random.default_rng(0), device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        preps.append(got)
    # GeoRegModel's argument order: src then ref of each input
    order = [p[k] for k in ("sp", "inv", "eig", "pmask", "mask") for p in preps]
    cfg = jgeo.GeoModelConfig(**meta["cfg"])
    want = jax.jit(jgeo.GeoRegModel(cfg).apply)({"params": tree},
                                                *(jnp.asarray(a) for a in order))
    model = geo_model.GeoRegModel(geo_model.GeoModelConfig(**meta["cfg"]))
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a)[None] for a in order))
    for key in ("log_assign", "src_feats", "ref_feats", "src_pf", "ref_pf"):
        assert normwise(got[key][0].numpy(), np.asarray(want[key])) < 1e-4, key
    want_c = jlearned.extract_correspondences(want, *preps, 24)
    got_c = learned.extract_correspondences({"log_assign": got["log_assign"][0].numpy()},
                                            *preps, 24)
    np.testing.assert_array_equal(got_c[3], want_c[3])
    assert len(got_c[3]) >= 3


# ------------------------------ host functions ------------------------------

def test_host_functions_equal():
    rng = np.random.default_rng(6)
    s, m = 10, 7
    patch = rng.normal(size=(s, m, 3)).astype(np.float32)
    for got, want in zip(learned.patch_invariants(patch), jlearned.patch_invariants(patch)):
        np.testing.assert_array_equal(got, want)

    def cloud():
        sp = rng.normal(size=(s, 3)).astype(np.float32)
        pm = rng.random((s, m)) < 0.8
        return {"sp": sp, "patch": rng.normal(size=(s, m, 3)).astype(np.float32),
                "pmask": pm, "mask": np.arange(s) < 8}

    src, ref = cloud(), cloud()
    la = np.log(rng.dirichlet(np.ones(s + 1), size=s + 1)).astype(np.float32)
    got = learned.extract_correspondences({"log_assign": la}, src, ref, 5)
    want = jlearned.extract_correspondences({"log_assign": la}, src, ref, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fla = np.log(rng.dirichlet(np.ones(m + 1) * 0.3, size=(5, m + 1))).astype(np.float32)
    for thresh in (0.2, 0.05):
        got = learned.extract_fine_correspondences(fla, want[3], 4, src, ref, thresh)
        wnt = jlearned.extract_fine_correspondences(fla, want[3], 4, src, ref, thresh)
        for g, w in zip(got, wnt):
            np.testing.assert_array_equal(g, w)
    a, b, w = rng.normal(size=(20, 3)), rng.normal(size=(20, 3)), rng.random(20)
    np.testing.assert_array_equal(learned.weighted_kabsch(a, b, w),
                                  jlearned.weighted_kabsch(a, b, w))


# ------------------------- batched RANSAC and ICP ---------------------------

@pytest.mark.parametrize("repeated", [False, True], ids=["distinct", "repeated"])
def test_ransac_hypotheses_batch_matches_jax_f64(x64, injected, repeated):
    """Against the JAX function with its draws: transforms within 1e-9,
    scores equal. With points repeated, as the fine stage's sets repeat
    them, a minimal set with a repeated point (two draws of one base
    point) gets the identity and score 0 instead (the JAX package scores
    whatever rotation its SVD returns)."""
    from sgaligner_tpu.reg import ransac as jransac

    rng = np.random.default_rng(7)
    g, n, iters, seed = 3, 64, 300, 11
    counts = [64, 40, 9]
    base = np.arange(n)
    if repeated:
        base = np.concatenate([np.arange(40), rng.integers(0, 40, size=n - 40)])
    src = rng.uniform(-1, 1, size=(g, n, 3))[:, base]
    tf = jlearned.weighted_kabsch(src[0, :3], src[0, :3] @ np.linalg.qr(
        rng.normal(size=(3, 3)))[0].T, np.ones(3))
    ref = src @ tf[:3, :3].T + tf[:3, 3] + rng.normal(0, 0.01, size=src.shape)
    ref[:, ::3] = rng.uniform(-1, 1, size=ref[:, ::3].shape)
    mask = np.arange(n)[None] < np.asarray(counts)[:, None]
    src[~mask], ref[~mask] = 0.0, 0.0
    thr = np.array([0.03, 0.05, 0.1])
    pair_ids, roles = [0, 0, 3], [0, 1, 1]
    base_key = jax.random.key(np.uint32(seed))
    keys = jnp.stack([jax.random.fold_in(jax.random.fold_in(base_key, p), r)
                      for p, r in zip(pair_ids, roles)])
    jtfs, jscores = expect_dtype(jransac.ransac_hypotheses_batch(
        *to_jax(src, ref), jnp.asarray(mask), keys, *to_jax(thr), iters=iters))
    tfs, scores = ransac.ransac_hypotheses_batch(
        torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(mask), seed,
        pair_ids, roles, torch.from_numpy(thr), iters=iters)
    assert tfs.dtype == torch.float64
    b = base[np.stack([jax_instance_draw(seed, p, r, c, n, iters).numpy()
                       for p, r, c in zip(pair_ids, roles, counts)])]
    degenerate = (b[..., 0] == b[..., 1]) | (b[..., 0] == b[..., 2]) | (b[..., 1] == b[..., 2])
    assert degenerate.any() == repeated
    np.testing.assert_array_equal(tfs.numpy()[degenerate],
                                  np.broadcast_to(np.eye(4), (degenerate.sum(), 4, 4)))
    np.testing.assert_array_equal(scores.numpy()[degenerate], 0.0)
    np.testing.assert_allclose(tfs.numpy()[~degenerate], np.asarray(jtfs)[~degenerate],
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(scores.numpy()[~degenerate],
                                  np.asarray(jscores)[~degenerate])
    assert scores[0].max() > 0.5 * counts[0]


def test_port_instance_draw_is_keyed_by_identity():
    a = ransac.draw_instance_sets(3, 5, 0, 40, 64, 100)
    assert torch.equal(a, ransac.draw_instance_sets(3, 5, 0, 40, 128, 100))
    for other in ((4, 5, 0), (3, 6, 0), (3, 5, 1)):
        assert not torch.equal(a, ransac.draw_instance_sets(*other, 40, 64, 100))
    assert int(a.max()) < 40 and a.shape == (100, 3)


@pytest.mark.parametrize("anchors", [False, True])
def test_icp_stages_batch_matches_jax(anchors):
    from sgaligner_tpu.reg import icp as jicp
    from sgaligner_tpu.reg.kabsch_test_helpers import random_transform
    from sgaligner_tpu_torch.reg import icp

    rng = np.random.default_rng(8)
    g, n, m, p = 3, 300, 260, 16
    src = rng.uniform(-1, 1, size=(g, n, 3)).astype(np.float32)
    ref = np.zeros((g, m, 3), np.float32)
    inits = np.zeros((g, 4, 4), np.float32)
    for i in range(g):
        tf = random_transform(rng, 4.0, 0.05)
        ref[i] = (src[i, :m] @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
        inits[i] = np.eye(4)
    src_m = np.arange(n)[None] < np.array([[300], [250], [280]])
    ref_m = np.arange(m)[None] < np.array([[260], [200], [240]])
    a_src = rng.uniform(-1, 1, size=(g, p, 3)).astype(np.float32)
    a_ref = (a_src + rng.normal(0, 0.02, size=a_src.shape)).astype(np.float32)
    a_w = (rng.random((g, p)) * (np.arange(p) < 12)).astype(np.float32)
    trims = np.array([0.3, 0.1, 0.05], np.float32)
    extra = (a_src, a_ref, a_w) if anchors else (None, None, None)
    want = np.asarray(jicp.icp_refine_stages_batch(src, ref, src_m, ref_m, inits, trims,
                                                   *extra, anchor_frac=0.15, iters=4,
                                                   chunk=128))
    got = icp.icp_refine_stages_batch(
        *(torch.from_numpy(a) for a in (src, ref, src_m, ref_m, inits, trims)),
        *(None if a is None else torch.from_numpy(a) for a in extra),
        anchor_frac=0.15, iters=4, chunk=128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------- the whole backend -----------------------------

@pytest.fixture(scope="module")
def backends(tracked):
    """The JAX and the port's LearnedBackend with the tracked weights
    (float32), the port's on the CPU (it fits at float64, the JAX package
    at float32)."""
    tree, sd, meta = tracked
    prep = {k: meta["prep"][k] for k in ("n_super", "patch_m", "voxel_size")}
    want = jlearned.LearnedBackend(params=tree, cfg=jgeo.GeoModelConfig(**meta["cfg"]),
                                   **prep)
    got = learned.LearnedBackend(params=sd, cfg=geo_model.GeoModelConfig(**meta["cfg"]),
                                 **prep, device="cpu")
    return got, want


def _recording(fn, log):
    """register_round, each round's pair ids appended to ``log``."""
    def recorded(be, pairs, seed, diversify_fps=False, pair_ids=None):
        log.append(list(pair_ids))
        return fn(be, pairs, seed, diversify_fps=diversify_fps, pair_ids=pair_ids)
    return recorded


def test_register_batch_matches_jax(backends, injected, monkeypatch):
    """Four pairs of 1,024-point crops at overlaps 0.6, 0.4, 0.25 and 0.3:
    the same retry rounds, the same declined pairs, equal correspondence
    counts (points within 1e-5), transforms within 1e-4, fit_score within
    1e-5. (The tracked weights, not a random tiny matcher: a wrong
    registration's trimmed ICP is chaotic, and the rounding of two
    libraries' SVDs carried a random matcher's transforms far past 1e-4.)"""
    from sgaligner_tpu.reg import learned_batch as jlb
    from sgaligner_tpu.reg.synthetic_pairs import make_pair
    from sgaligner_tpu_torch.reg import learned_batch as lb

    got_be, want_be = backends
    rng = np.random.default_rng(12)
    pairs = [make_pair(rng, n_points=1024, overlap=ov)[:2] for ov in (0.6, 0.4, 0.25, 0.3)]
    rounds = {"got": [], "want": []}
    monkeypatch.setattr(lb, "register_round", _recording(lb.register_round, rounds["got"]))
    monkeypatch.setattr(jlb, "register_round",
                        _recording(jlb.register_round, rounds["want"]))
    want = want_be.register_batch(pairs)
    got = got_be.register_batch(pairs)
    assert rounds["got"] == rounds["want"] and len(rounds["want"]) > 1, rounds
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(w is not None for w in want) >= 3
    for g, w in zip(got, want):
        if w is None:
            continue
        assert len(g["corr_scores"]) == len(w["corr_scores"])
        for k in ("src_corr_points", "ref_corr_points", "corr_scores"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["estimated_transform"], w["estimated_transform"],
                                   rtol=0, atol=1e-4)
        assert abs(g["fit_score"] - w["fit_score"]) <= 1e-5


class _Replay:
    """A backend that answers every pair with a transform drawn from a
    seeded generator, the same on both sides (every third pair declined)."""

    def __init__(self):
        self.calls = 0

    def register_batch(self, pairs):
        from sgaligner_tpu.reg.kabsch_test_helpers import random_transform

        out = []
        for src, ref in pairs:
            self.calls += 1
            rng = np.random.default_rng(self.calls)
            if self.calls % 3 == 0:
                out.append(None)
                continue
            n = min(len(src), len(ref), 40)
            out.append({"estimated_transform": random_transform(rng, 8.0, 0.1),
                        "src_corr_points": src[:n], "ref_corr_points": ref[:n],
                        "corr_scores": rng.random(n).astype(np.float32)})
        return out


def test_eval_geo_matches_jax():
    """``evaluate`` (patches and room scenes, two bands) and
    ``evaluate_cloud`` on the same replayed registrations: equal
    aggregates (hits, fails, FMR, RR, the error means to 1e-12)."""
    from sgaligner_tpu.reg import eval_geo as jeval
    from sgaligner_tpu_torch.reg import eval_geo

    cloud = np.random.default_rng(3).uniform(-2, 2, size=(4000, 3)).astype(np.float32)
    for fn, args, kw in (("evaluate", (), dict(overlaps=(0.3, 0.5), n_pairs=3, seed=31,
                                              n_points=512)),
                         ("evaluate", (), dict(overlaps=(0.4,), n_pairs=3, seed=5,
                                              n_points=512, scene_kind="room")),
                         ("evaluate_cloud", (cloud,), dict(overlaps=(0.5,), n_pairs=3))):
        want = getattr(jeval, fn)(_Replay(), *args, verbose=False, **kw)
        got = getattr(eval_geo, fn)(_Replay(), *args, verbose=False, **kw)
        assert got.keys() == want.keys()
        for ov in want:
            assert got[ov].keys() == want[ov].keys()
            np.testing.assert_allclose([got[ov][k] for k in want[ov]],
                                       [want[ov][k] for k in want[ov]], rtol=1e-12,
                                       err_msg=f"{fn} {ov}")
            assert want[ov]["fails"] > 0 and want[ov]["n"] == 3


def test_build_backend_learned():
    """``backend: learned`` builds the port's LearnedBackend with the tracked
    weights on the device asked for; the card without one raises."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.reg.backend import GEO_CHECKPOINT, build_backend

    cfg = make_cfg(model_name="sgaligner", modules=["point"])
    cfg.reg_model.backend = "learned"
    be = build_backend(cfg, device="cpu")
    assert isinstance(be, learned.LearnedBackend) and be.device == torch.device("cpu")
    want = learned.load_geo_checkpoint(GEO_CHECKPOINT)[0]
    got = be.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_backend(cfg)
