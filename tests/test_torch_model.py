"""The port's data contract, weight bridge and MultiModalEncoder forward
against the JAX package, on the CPU.

* data: BatchSpec / make_synthetic_batch / pool_compact copies give arrays
  identical to the JAX package's for the same seed, and so do the numpy
  copies ``align/alignment.py`` and ``utils/pointcloud.py``; the config's
  ``reg_model`` section has the JAX fields and defaults;
* weight bridge: ``torch_state_dict_to_params(port.state_dict())`` returns
  the flax tree the port was loaded from, leaf for leaf;
* the whole 4-modality eval forward at float64 on a pooled batch with
  non-trivial BN running stats, against ``MultiModalEncoder.apply`` with the
  Pallas kernels (interpret mode) and with the plain XLA path, at rtol 1e-5 /
  atol 1e-7 on valid rows (the bound of tests/test_full_model_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
from sgaligner_tpu.data import batch as jax_batch
from sgaligner_tpu.data import synthetic as jax_synth
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu_torch.core.checkpoint import (loss_state_dict_from_flax,
                                                 state_dict_from_flax)
from sgaligner_tpu_torch.data import batch as port_batch
from sgaligner_tpu_torch.data import synthetic as port_synth
from sgaligner_tpu_torch.data.batch import to_device
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.ops.objective import OverallLoss
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)

MODULES = ("pct", "gat", "rel", "attr")
POINT_MODULES = ("point", "gat", "rel", "attr")
SPEC_ARGS = dict(batch_size=3, max_objects=10, points_per_object=32)
BUCKET = 16


# ---- reference-shaped state_dict fixtures (copied from the JAX suite) ----

def make_torch_state_dict(rng):
    """Reference-shaped random state_dict for the gat/rel/attr/fusion
    modules (keys as upstream torch saves them)."""

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    sd = {}
    for i, cin in enumerate([3, 256]):
        sd[f"structure_encoder.layer_stack.{i}.lin_src.weight"] = t(2 * 128, cin)
        sd[f"structure_encoder.layer_stack.{i}.att_src"] = t(1, 2, 128)
        sd[f"structure_encoder.layer_stack.{i}.att_dst"] = t(1, 2, 128)
        sd[f"structure_encoder.layer_stack.{i}.bias"] = t(2 * 128)
    sd["structure_embedding.weight"] = t(100, 256)
    sd["structure_embedding.bias"] = t(100)
    sd["meta_embedding_rel.weight"] = t(100, 41)
    sd["meta_embedding_rel.bias"] = t(100)
    sd["meta_embedding_attr.weight"] = t(100, 164)
    sd["meta_embedding_attr.bias"] = t(100)
    sd["fusion.weight"] = torch.tensor(
        rng.normal(size=(4, 1)).astype(np.float32))
    return sd


def make_torch_pct_state_dict(rng):
    """NaivePCT keys as upstream saves them, plus the other modules."""

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    def bn(prefix, c, sd):
        sd[f"{prefix}.weight"] = torch.ones(c)
        sd[f"{prefix}.bias"] = torch.zeros(c)
        sd[f"{prefix}.running_mean"] = torch.zeros(c)
        sd[f"{prefix}.running_var"] = torch.ones(c)

    sd = {}
    sd["object_encoder.embedding.conv1.weight"] = t(128, 3, 1)
    sd["object_encoder.embedding.conv2.weight"] = t(128, 128, 1)
    bn("object_encoder.embedding.bn1", 128, sd)
    bn("object_encoder.embedding.bn2", 128, sd)
    for s in (1, 2, 3, 4):
        p = f"object_encoder.sa{s}"
        qk = t(32, 128, 1)
        sd[f"{p}.q_conv.weight"] = qk
        sd[f"{p}.k_conv.weight"] = qk
        sd[f"{p}.v_conv.weight"] = t(128, 128, 1)
        sd[f"{p}.v_conv.bias"] = t(128)
        sd[f"{p}.trans_conv.weight"] = t(128, 128, 1)
        sd[f"{p}.trans_conv.bias"] = t(128)
        bn(f"{p}.after_norm", 128, sd)
    sd["object_encoder.linear.0.weight"] = t(1024, 512, 1)
    bn("object_encoder.linear.1", 1024, sd)
    sd["object_encoder.linear1.weight"] = t(512, 1024)
    bn("object_encoder.bn1", 512, sd)
    sd["object_encoder.linear2.weight"] = t(256, 512)
    sd["object_encoder.linear2.bias"] = t(256)
    bn("object_encoder.bn2", 256, sd)
    sd["object_embedding.weight"] = t(100, 256)
    sd["object_embedding.bias"] = t(100)
    sd.update(make_torch_state_dict(np.random.default_rng(9)))
    return sd


def scaled_pct_state_dict(rng, scale=0.08):
    """Non-trivial BN running stats and realistic-magnitude conv weights
    (N(0,1) weights overflow the 4-block residual stack)."""
    sd = make_torch_pct_state_dict(rng)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = torch.tensor(rng.normal(size=sd[k].shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.tensor(
                (0.5 + rng.random(sd[k].shape)).astype(np.float32))
        elif "object_encoder" in k and k.endswith(".weight") and sd[k].ndim > 1:
            sd[k] = sd[k] * scale
    return sd


def port_model_from(params, batch_stats, dtype=torch.float64, modules=MODULES):
    model = MultiModalEncoder(modules, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(params, batch_stats, modules))
    return model


def jax_inputs(batch):
    """The batch as JAX arrays, floating ones at float64 (asserted)."""
    return expect_dtype({k: (jnp.asarray(v, jnp.float64)
                             if np.issubdtype(np.asarray(v).dtype, np.floating) else
                             jnp.asarray(v)) for k, v in batch.items()},
                        what="JAX batch")


def valid_rows(batch, emb_flat):
    """Flat [B*2N, D] output restricted to valid slots, dataset order."""
    b, two_n = batch["obj_mask"].shape
    n = two_n // 2
    emb = np.asarray(emb_flat).reshape(b, two_n, -1)
    rows = []
    for i in range(b):
        rows.append(emb[i, :int(batch["n_src"][i])])
        rows.append(emb[i, n:n + int(batch["n_ref"][i])])
    return np.concatenate(rows, axis=0)


# ----------------------------------- data -----------------------------------

@pytest.mark.parametrize("compact_slots", [0, 24])
def test_data_copies_match_jax_package(compact_slots):
    kw = dict(SPEC_ARGS, compact_slots=compact_slots)
    want = jax_synth.make_synthetic_batch(jax_batch.BatchSpec(**kw), seed=7,
                                          bow_noise=0.3)
    got = port_synth.make_synthetic_batch(port_batch.BatchSpec(**kw), seed=7,
                                          bow_noise=0.3)
    assert port_batch.BatchSpec(**kw).total_slots == jax_batch.BatchSpec(**kw).total_slots
    for which, w, g in (("batch", want, got),
                        ("pooled", jax_batch.pool_compact(want, BUCKET),
                         port_batch.pool_compact(got, BUCKET))):
        assert sorted(w) == sorted(g), which
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=f"{which}:{k}")
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
    dev = to_device(port_batch.pool_compact(got, BUCKET), "cpu")
    assert dev["pooled_flat_idx"].dtype == torch.int64
    assert dev["pooled_mask"].dtype == torch.bool
    assert dev["obj_points_pooled"].dtype == torch.float32


def _alignment_case():
    from sgaligner_tpu.align import alignment as want
    from sgaligner_tpu_torch.align import alignment as got

    rng = np.random.default_rng(4)
    sim = rng.random((12, 12))
    sim[2, 7] = sim[2, 9]                        # a tie: the stable order decides
    sim[:, 11] = sim[11, :] = 1e30
    ids = np.arange(12) + 100
    calls = [("compute_node_corrs", (sim, 5, 6, 2)),
             ("compute_alignment_score", (sim, 5, 4, 6)),
             ("precision_recall_f1", ([1, 0, 1, 1, 0], [1, 1, 0, 1, 0]))]
    corrs = want.compute_node_corrs(sim, 5, 6, k=2)
    calls.append(("get_node_corrs_objects_ids", (corrs, ids)))
    return got, want, calls


def _pointcloud_case():
    from sgaligner_tpu.utils import pointcloud as want
    from sgaligner_tpu_torch.utils import pointcloud as got

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3))
    tf = np.eye(4)
    tf[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tf[:3, 3] = rng.normal(size=3)
    calls = [("apply_transform", (pts, tf)),
             ("apply_transform", (pts, tf, pts[::-1])),
             ("inverse_relative", (tf,)),
             ("get_nearest_neighbor", (pts[:50] + 0.01, pts, True)),
             ("compute_pcl_overlap", (np.concatenate([pts[:40], pts[:10] + 1.0]), pts))]
    return got, want, calls


@pytest.mark.parametrize("case", [_alignment_case, _pointcloud_case],
                         ids=["alignment", "pointcloud"])
def test_numpy_copies_match_jax_package(case):
    """align/alignment.py and utils/pointcloud.py (the parts the port
    copies): the same outputs for the same inputs."""
    got, want, calls = case()
    for name, args in calls:
        g, w = getattr(got, name)(*args), getattr(want, name)(*args)
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    if case is _pointcloud_case:             # farthest sampling: the same rng draws
        pts = np.random.default_rng(6).normal(size=(200, 3))
        for n in (64, 400):
            a = got.pcl_farthest_sample(pts, n, True, np.random.default_rng(1))
            b = want.pcl_farthest_sample(pts, n, True, np.random.default_rng(1))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_config_reg_model_matches_jax_package():
    """The reg_model section: the JAX package's fields and defaults, and a
    JAX config with it merges without a warning."""
    import dataclasses
    import warnings

    from sgaligner_tpu.core import config as jconfig
    from sgaligner_tpu_torch.core import config as pconfig

    want = dataclasses.asdict(jconfig.make_cfg().reg_model)
    assert dataclasses.asdict(pconfig.make_cfg().reg_model) == want
    values = {"registration": True, "reg_model": dict(want, K=2, coarse="pca")}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = pconfig.make_cfg(**values)
    assert cfg.reg_model.K == 2 and cfg.reg_model.coarse == "pca" and cfg.registration


# ------------------------------- weight bridge ------------------------------

@pytest.mark.parametrize("modules", [MODULES, POINT_MODULES],
                         ids=["pct", "point"])
def test_weight_bridge_round_trip(modules):
    """flax tree -> port state_dict -> torch_state_dict_to_params == tree;
    the loss parameters through the objective's state_dict likewise."""
    batch = port_synth.make_synthetic_batch(port_batch.BatchSpec(**SPEC_ARGS),
                                            seed=1)
    variables = JaxEncoder(modules=modules).init(jax.random.key(0), batch,
                                                 train=False)
    rng = np.random.default_rng(4)
    # random values everywhere (init leaves BN stats at 0 / 1)
    params = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda a: rng.random(a.shape).astype(np.float32) + 0.5,
        variables.get("batch_stats", {}))

    model = port_model_from(params, stats, dtype=torch.float32, modules=modules)
    sd = model.state_dict()
    if "pct" in modules:
        assert sd["object_encoder.sa1.q_conv.weight"].shape == (32, 128, 1)
    else:
        assert sd["object_encoder.conv3.weight"].shape == (256, 128, 1)
        assert sd["object_encoder.conv1.bias"].shape == (64,)
    assert sd["structure_encoder.layer_stack.0.lin_src.weight"].shape == (256, 3)
    assert sd["structure_encoder.layer_stack.1.att_src"].shape == (1, 2, 128)
    loss = {"ial_log_vars": rng.normal(size=4).astype(np.float32),
            "icl_log_vars": rng.normal(size=4).astype(np.float32)}
    objective = OverallLoss(modules)
    objective.load_state_dict(loss_state_dict_from_flax(loss))
    for k, v in objective.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), loss[k])
    back_p, back_s = torch_state_dict_to_params(sd, modules)
    for want, got in ((params, back_p), (stats, back_s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            assert path in flat_g, jax.tree_util.keystr(path)
            np.testing.assert_array_equal(
                np.asarray(flat_g[path]), leaf,
                err_msg=jax.tree_util.keystr(path))


# ------------------------------ encoder forward -----------------------------

def test_encoder_eval_forward_matches_jax_f64(x64):
    rng = np.random.default_rng(12)
    sd = scaled_pct_state_dict(rng)
    params, stats = torch_state_dict_to_params(sd, MODULES)
    batch = port_batch.pool_compact(
        port_synth.make_synthetic_batch(port_batch.BatchSpec(**SPEC_ARGS),
                                        seed=5), BUCKET)
    assert batch["obj_points_pooled"].shape[0] % BUCKET == 0

    model = port_model_from(params, stats)
    with torch.inference_mode():
        got = model(to_device(batch, "cpu"))
    # the unpooled layout gives the same embeddings
    plain = port_synth.make_synthetic_batch(port_batch.BatchSpec(**SPEC_ARGS),
                                            seed=5)
    with torch.inference_mode():
        got_unpooled = model(to_device(plain, "cpu"))

    p64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
    s64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats))
    jb = jax_inputs(batch)
    for fused in ("always", "never"):
        want = expect_dtype(JaxEncoder(modules=MODULES, pointnet_fused=fused,
                                       dtype=jnp.float64).apply(
            {"params": p64, "batch_stats": s64}, jb, train=False))
        for m in (*MODULES, "joint"):
            for name, out in (("pooled", got), ("unpooled", got_unpooled)):
                np.testing.assert_allclose(
                    valid_rows(batch, out[m].numpy()),
                    valid_rows(batch, want[m]), rtol=1e-5, atol=1e-7,
                    err_msg=f"{m} ({name}, JAX fused={fused})")


# ------------------------------ training guards -----------------------------

def test_training_mode_guards():
    """Both configurations switch to their training form; the options the
    port does not have yet raise, and gradient accumulation (ported) builds
    its train state (``tests/test_torch_trainer.py`` holds it to JAX)."""
    from sgaligner_tpu_torch.core.config import make_cfg
    from sgaligner_tpu_torch.engine.factory import build_optimizer
    from sgaligner_tpu_torch.engine.train_step import create_train_state
    from sgaligner_tpu_torch.models.pointnet import PointNetEncoder

    point = MultiModalEncoder(POINT_MODULES)
    assert not point.training
    assert point.train(True).training and point.structure_encoder.training
    pct = MultiModalEncoder(MODULES)
    assert not pct.training
    assert pct.train(True).training and pct.object_encoder.sa4.after_norm.training
    assert not pct.train(False).object_encoder.training
    with pytest.raises(NotImplementedError, match="active"):
        PointNetEncoder(bn_mode="active")
    cfg = make_cfg(modules=list(POINT_MODULES), optim={"grad_acc_steps": 2})
    assert isinstance(build_optimizer(cfg, point.parameters()), torch.optim.Adam)
    state = create_train_state(point, cfg)
    assert (state.acc_steps, state.mini, state.acc) == (2, 0, None)
