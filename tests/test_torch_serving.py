"""The port's serving step against the JAX package's ``make_serving_step`` at
float64, and its metrics on the crafted cases of tests/test_metrics_golden.py
(copied), including exact similarity ties. Integer counts must agree
exactly; rr_sum and alignment_score to 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
from sgaligner_tpu.engine.train_step import make_serving_step as jax_serving_step
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu.ops import metrics as JM
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import make_serving_step, serve_queue
from sgaligner_tpu_torch.ops import metrics as M
from tests.test_torch_model import (MODULES, jax_inputs, port_model_from,
                                    scaled_pct_state_dict)
from tests.test_torch_ops import expect_dtype, to_jax, x64  # noqa: F401  (fixture)

KS = (1, 2, 3, 4, 5)


def _assert_components(got, want):
    expect_dtype(want, what="JAX serving step")
    assert int(got["rr_count"]) == int(want["rr_count"])
    np.testing.assert_allclose(float(got["rr_sum"]), float(want["rr_sum"]),
                               rtol=1e-9)
    np.testing.assert_allclose(got["alignment_score"].numpy(),
                               np.asarray(want["alignment_score"]), rtol=1e-9)
    for k in KS:
        assert tuple(int(v) for v in got[f"hits@{k}"]) == \
            tuple(int(v) for v in want[f"hits@{k}"]), k


def test_serving_step_matches_jax_f64(x64):
    """Pooled batches with noisy BoW and resampled anchor shapes (so the
    ranks are not all 1); a two-batch queue sums like make_serving_queue."""
    rng = np.random.default_rng(21)
    sd = scaled_pct_state_dict(rng, scale=0.05)
    params, stats = torch_state_dict_to_params(sd, MODULES)
    spec = BatchSpec(batch_size=3, max_objects=10, points_per_object=32)
    batches = [pool_compact(make_synthetic_batch(
        spec, seed=s, bow_noise=1.0, resample=True), 16) for s in (8, 9)]

    model = port_model_from(params, stats)
    step = make_serving_step(model, MODULES, KS)
    got = [step(to_device(b, "cpu")) for b in batches]
    queue = serve_queue(model, MODULES, [to_device(b, "cpu") for b in batches],
                        KS)

    p64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
    s64 = expect_dtype(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats))
    jstep = jax_serving_step(
        JaxEncoder(modules=MODULES, pointnet_fused="never",
                   dtype=jnp.float64), MODULES, KS)
    want = [jstep({"model": p64}, s64, jax_inputs(b)) for b in batches]
    for g, w in zip(got, want):
        _assert_components(g, w)
    assert any(float(w["rr_sum"]) < int(w["rr_count"]) for w in want)
    np.testing.assert_allclose(
        queue["rr_sum"].item(), sum(float(w["rr_sum"]) for w in want),
        rtol=1e-9)
    assert queue["alignment_score"].shape == (2, 3)
    for k in KS:
        assert int(queue[f"hits@{k}"][0]) == sum(
            int(w[f"hits@{k}"][0]) for w in want)


# ---- crafted cases (copied from tests/test_metrics_golden.py) ----

def make_case(rng, n_src, n_ref, ties=False):
    n = n_src + n_ref
    emb = rng.normal(size=(n, 8))
    if ties:
        emb[1] = emb[0]              # duplicate rows -> exact sim ties
        emb[n_src + 1] = emb[n_src]
    return emb


def to_padded(emb, n_src, n_ref, n_max):
    two_n = 2 * n_max
    out = np.zeros((1, two_n, emb.shape[1]), np.float64)
    out[0, :n_src] = emb[:n_src]
    out[0, n_max:n_max + n_ref] = emb[n_src:]
    mask = np.zeros((1, two_n), bool)
    mask[0, :n_src] = True
    mask[0, n_max:n_max + n_ref] = True
    return out, mask


def slot_of(i, n_src, n_max):
    return i if i < n_src else n_max + (i - n_src)


def golden_mrr_hits(sim_valid, e1i, e2i, ks):
    """The reference's rank-list surgery: stable argsort, remove self."""
    rank_list = np.argsort(sim_valid, axis=1, kind="stable")
    rrs, hits = [], {k: 0 for k in ks}
    for i, r in enumerate(e1i):
        row = list(rank_list[r])
        row.remove(r)
        rrs.append(1.0 / (row.index(e2i[i]) + 1))
        for k in ks:
            hits[k] += int(e2i[i] in row[:k])
    return rrs, hits


@pytest.mark.parametrize("ties", [False, True], ids=["no_ties", "ties"])
def test_metrics_match_jax_and_reference_on_crafted_cases(x64, ties):
    rng = np.random.default_rng(0 if not ties else 5)
    n_src, n_ref, n_max = 6, 7, 10
    emb = make_case(rng, n_src, n_ref, ties=ties)
    embn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim_valid = 1.0 - embn @ embn.T
    e1i = np.array([0, 1, 2, 3])
    e2i = np.array([n_src, n_src + 1, n_src + 2, n_src + 3])
    rrs_gold, hits_gold = golden_mrr_hits(sim_valid, e1i, e2i, (1, 3, 5))

    padded, mask = to_padded(emb, n_src, n_ref, n_max)
    e1i_s = np.array([[slot_of(i, n_src, n_max) for i in e1i]])
    e2i_s = np.array([[slot_of(i, n_src, n_max) for i in e2i]])
    am = np.ones((1, 4), bool)

    sim = M.cosine_sim_matrix(torch.from_numpy(padded), torch.from_numpy(mask))
    ranks, rmask = M.anchor_ranks(sim, torch.from_numpy(e1i_s),
                                  torch.from_numpy(e2i_s), torch.from_numpy(am))
    np.testing.assert_allclose((1.0 / ranks.numpy()[0]).tolist(), rrs_gold,
                               rtol=1e-9)
    hits = M.hits_at_k_from_ranks(ranks, rmask, (1, 3, 5))
    for k in (1, 3, 5):
        assert int(hits[k][0]) == hits_gold[k]
    score = M.alignment_score(sim, torch.tensor([n_src]), torch.tensor([n_ref]),
                              n_max)

    jsim = expect_dtype(JM.cosine_sim_matrix(*to_jax(padded, mask)))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=1e-12,
                               atol=1e-12)
    jranks, jmask = JM.anchor_ranks(jsim, jnp.asarray(e1i_s),
                                    jnp.asarray(e2i_s), jnp.asarray(am))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    rr, cnt = M.mrr_from_ranks(ranks, rmask)
    jrr, jcnt = expect_dtype(JM.mrr_from_ranks(jranks, jmask))
    np.testing.assert_allclose(rr.item(), float(jrr), rtol=1e-9)
    assert int(cnt) == int(jcnt)
    jscore = expect_dtype(JM.alignment_score(jsim, jnp.array([n_src]),
                                             jnp.array([n_ref]), n_max))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               rtol=1e-9)
