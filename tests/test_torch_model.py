"""The port's data contract, weight bridge and MultiModalEncoder forward
against the JAX package, on the CPU.

* data: BatchSpec / make_synthetic_batch / pool_compact copies give arrays
  identical to the JAX package's for the same seed;
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
from sgaligner_tpu_torch.core.checkpoint import state_dict_from_flax
from sgaligner_tpu_torch.data import batch as port_batch
from sgaligner_tpu_torch.data import synthetic as port_synth
from sgaligner_tpu_torch.data.batch import to_device
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder

MODULES = ("pct", "gat", "rel", "attr")
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


def port_model_from(params, batch_stats, dtype=torch.float64):
    model = MultiModalEncoder(MODULES, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(params, batch_stats, MODULES))
    return model


def jax_inputs(batch):
    return {k: (jnp.asarray(v, jnp.float64)
                if np.issubdtype(np.asarray(v).dtype, np.floating) else
                jnp.asarray(v)) for k, v in batch.items()}


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


# ------------------------------- weight bridge ------------------------------

def test_weight_bridge_round_trip():
    """flax tree -> port state_dict -> torch_state_dict_to_params == tree."""
    batch = port_synth.make_synthetic_batch(port_batch.BatchSpec(**SPEC_ARGS),
                                            seed=1)
    variables = JaxEncoder(modules=MODULES).init(jax.random.key(0), batch,
                                                 train=False)
    rng = np.random.default_rng(4)
    # random values everywhere (init leaves BN stats at 0 / 1)
    params = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda a: rng.random(a.shape).astype(np.float32) + 0.5,
        variables["batch_stats"])

    model = port_model_from(params, stats, dtype=torch.float32)
    sd = model.state_dict()
    assert sd["object_encoder.sa1.q_conv.weight"].shape == (32, 128, 1)
    assert sd["structure_encoder.layer_stack.0.lin_src.weight"].shape == (256, 3)
    assert sd["structure_encoder.layer_stack.1.att_src"].shape == (1, 2, 128)
    back_p, back_s = torch_state_dict_to_params(sd, MODULES)
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

def test_encoder_eval_forward_matches_jax_f64():
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

    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)
        jb = jax_inputs(batch)
        for fused in ("always", "never"):
            want = JaxEncoder(modules=MODULES, pointnet_fused=fused,
                              dtype=jnp.float64).apply(
                {"params": p64, "batch_stats": s64}, jb, train=False)
            for m in (*MODULES, "joint"):
                for name, out in (("pooled", got), ("unpooled", got_unpooled)):
                    np.testing.assert_allclose(
                        valid_rows(batch, out[m].numpy()),
                        valid_rows(batch, want[m]), rtol=1e-5, atol=1e-7,
                        err_msg=f"{m} ({name}, JAX fused={fused})")
    finally:
        jax.config.update("jax_enable_x64", False)
