"""The port's serving artifact (sgaligner_tpu_torch/serving.py) on the CPU.

The artifact is a ``torch.export`` program of the serving step with the
kernels' custom ops inside (their CPU bodies, the plain versions, run
here). Its outputs are bit-equal to the port's ``make_serving_step`` /
``serve_queue`` on the same prepared batches, and, through
tests/test_torch_serving.py's harness at float64, match the JAX package's
``make_serving_step`` (integer counts equal; rr_sum, alignment_score and
sim to 1e-9). ``prepare`` refuses overflow, shape drift and missing
fields; the bfloat16 points input round-trips; an EVA artifact serves
pooled points; each custom op's fake gives the real outputs' shapes and
dtypes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
from sgaligner_tpu.engine.train_step import make_serving_step as jax_serving_step
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu_torch import serving
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import make_serving_step, serve_queue
from tests.test_torch_model import MODULES, jax_inputs, port_model_from, scaled_pct_state_dict
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)
from tests.test_torch_serving import KS, _assert_components

B, N, P, K = 3, 10, 32, 56
SPEC = BatchSpec(batch_size=B, max_objects=N, points_per_object=P)


def _cfg(modules=MODULES, model_name="sgaligner"):
    cfg = make_cfg(model_name=model_name, modules=list(modules))
    cfg.tpu.max_objects, cfg.tpu.points_per_object = N, P
    return cfg


def _hosts(seeds):
    return [make_synthetic_batch(SPEC, seed=s, bow_noise=1.0, resample=True)
            for s in seeds]


def assert_bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        for a, b in zip(got[k] if isinstance(got[k], tuple) else (got[k],),
                        w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.fixture(scope="module")
def weights():
    """Seeded pct weights as the port's state dict and the JAX tree."""
    sd = scaled_pct_state_dict(np.random.default_rng(21), scale=0.05)
    return torch_state_dict_to_params(sd, MODULES)


def test_artifact_matches_serving_step_and_jax(x64, weights, tmp_path):
    """The pct configuration with the similarity matrices: bit-equal to the
    port's step, and the JAX serving step at float64 on the same pooled
    batches."""
    params, stats = weights
    model = port_model_from(params, stats)
    hosts = _hosts((8, 9))
    p64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
    s64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats))
    jmodel = JaxEncoder(modules=MODULES, pointnet_fused="never", dtype=jnp.float64)

    art = serving.load_serving_artifact(serving.export_serving_artifact(
        _cfg(), model, str(tmp_path / "sim"), batch_size=B, pooled_bucket=K,
        with_sim=True, ks=KS), device="cpu")
    assert art.meta["pooled_k"] == K and art.meta["with_sim"]
    program = art._program.graph_module.code
    for op in ("embed_first", "embed_second", "pct_block_eval", "pct_tail"):
        assert f"sgaligner.{op}" in program, op
    step = make_serving_step(model, MODULES, KS, with_sim=True)
    jstep = jax_serving_step(jmodel, MODULES, KS, with_sim=True)
    for host in hosts:
        prepared = art.prepare(host)
        got, want = art(host), step(prepared)
        assert_bit_equal(got, want)
        jwant = jstep({"model": p64}, s64, jax_inputs(pool_compact(host, K)))
        _assert_components(got, jwant)
        np.testing.assert_allclose(got["sim"].numpy(), np.asarray(jwant["sim"]),
                                   rtol=1e-9, atol=1e-9)

    with pytest.raises(ValueError, match="single-batch"):
        serving.export_serving_artifact(_cfg(), model, str(tmp_path / "bad"),
                                        batch_size=B, queue=2, with_sim=True)


POINT = ("point", "gat", "rel", "attr")


def test_queue_artifact_matches_serve_queue(tmp_path):
    """A queue of two batches in one call: bit-equal to ``serve_queue``."""
    from sgaligner_tpu_torch.engine.factory import build_model

    cfg = _cfg(POINT)
    model = build_model(cfg, "cpu")
    hosts = _hosts((8, 9))
    art = serving.load_serving_artifact(serving.export_serving_artifact(
        cfg, model, str(tmp_path / "queue"), batch_size=B, pooled_bucket=K,
        queue=2), device="cpu")
    got = art(hosts)
    assert_bit_equal(got, serve_queue(model, POINT, [art.prepare(h) for h in hosts]))
    assert got["alignment_score"].shape == (2, B) and art.meta["queue"] == 2
    with pytest.raises(ValueError, match="list of 2"):
        art(hosts[:1])


def test_prepare_refuses_and_bf16_points_round_trip(tmp_path):
    """Overflow, shape drift and a missing field are refused at the host
    boundary; points pinned to bfloat16 are cast by prepare and serve close
    to the float32 artifact."""
    from sgaligner_tpu_torch.engine.factory import build_model

    cfg = _cfg(POINT)
    model = build_model(cfg, "cpu")
    host = make_synthetic_batch(SPEC, seed=3)
    kw = dict(batch_size=B, pooled_bucket=K)
    art32 = serving.load_serving_artifact(serving.export_serving_artifact(
        cfg, model, str(tmp_path / "f32"), **kw), device="cpu")
    out32 = art32(host)
    assert "sim" not in out32
    assert_bit_equal(out32, make_serving_step(model, POINT)(art32.prepare(host)))
    full = dict(host, obj_mask=np.ones_like(host["obj_mask"]))
    assert int(full["obj_mask"].sum()) > K
    with pytest.raises(ValueError, match="pooled_bucket"):
        art32.prepare(full)
    bad = dict(host)
    bad["bow_rel"] = bad["bow_rel"][:, :, :-1]
    with pytest.raises(ValueError, match="bow_rel"):
        art32.prepare(bad)
    with pytest.raises(KeyError, match="bow_attr"):
        art32.prepare({k: v for k, v in host.items() if k != "bow_attr"})

    art16 = serving.load_serving_artifact(serving.export_serving_artifact(
        cfg, model, str(tmp_path / "bf16"), points_dtype="bfloat16", **kw),
        device="cpu")
    assert art16.meta["batch_keys"]["obj_points_pooled"][1] == "bfloat16"
    p16 = art16.prepare(host)
    assert p16["obj_points_pooled"].dtype == torch.bfloat16
    out16 = art16(host)
    assert_bit_equal(out16, make_serving_step(model, POINT)(p16))
    np.testing.assert_allclose(float(out16["rr_sum"]), float(out32["rr_sum"]), rtol=0.2)
    np.testing.assert_allclose(out16["alignment_score"].numpy(),
                               out32["alignment_score"].numpy(), rtol=0.05, atol=0.02)
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.load_serving_artifact(str(tmp_path / "f32"), device="meta")


def test_eva_pooled_and_artifact(tmp_path):
    """EVA: the pooled point layout gives the dense layout's embeddings, and
    an EVA artifact serves pooled batches."""
    from sgaligner_tpu_torch.data.batch import to_device
    from sgaligner_tpu_torch.engine.factory import build_model

    cfg = _cfg(("point", "gcn", "rel", "attr"), model_name="eva")
    model = build_model(cfg, "cpu")
    host = make_synthetic_batch(SPEC, seed=3)
    with torch.inference_mode():
        dense = model(to_device(host, "cpu"))
        pooled = model(to_device(pool_compact(dict(host), bucket=K), "cpu"))
    for k in dense:
        torch.testing.assert_close(pooled[k], dense[k], rtol=2e-5, atol=2e-5)
    art = serving.load_serving_artifact(serving.export_serving_artifact(
        cfg, model, str(tmp_path / "eva"), batch_size=B, pooled_bucket=K),
        device="cpu")
    out = art(host)
    assert art.meta["model_name"] == "eva"
    assert np.isfinite(float(out["rr_sum"])) and int(out["rr_count"]) > 0
    assert_bit_equal(out, make_serving_step(model, cfg.modules)(art.prepare(host)))


def _op_args(name, dtype):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return (torch.randn(*shape, generator=g) * 0.3).to(dt)

    o, p = 5, 16
    mask = torch.ones(o, 1, dtype=dtype)
    if name == "embed_first":
        return (r(o, 3, p), r(3, 128), mask)
    if name == "embed_second":
        return (r(o, p, 128), r(1, 128), r(1, 128), r(128, 128), mask)
    if name == "pct_block_eval":
        return (r(o, p, 128), r(128, 32), r(128, 128), r(128), r(128, 128), r(128),
                r(128, dt=torch.float32), r(128, dt=torch.float32), True, False)
    if name in ("pct_tail", "pct_tail_indexed"):
        return (r(o, p, 128), r(o, p, 128), r(o, p, 128), r(o, p, 128), r(512, 256), mask)
    return (r(o, 3, p), r(3, 64), r(1, 64), r(64, 128), r(1, 128), r(128, 200), r(1, 200))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("name", ["embed_first", "embed_second", "pct_block_eval",
                                  "pct_tail", "pct_tail_indexed", "pointnet_pool",
                                  "pointnet_pool_argmax"])
def test_custom_op_fake_matches_real(name, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from sgaligner_tpu_torch.ops import library

    library.load()
    op = getattr(torch.ops.sgaligner, name)
    args = _op_args(name, dtype)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert len(real) == len(fake)
    for a, b in zip(real, fake):
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
