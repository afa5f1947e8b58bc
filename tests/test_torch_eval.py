"""The port's evaluation path against the JAX package, on the CPU: the
Scan3R data path, EVA with its GCN and NCA objective, and the tester CLIs on
the tracked trained snapshots.

* data: ``make_synthetic_workspace`` writes the same files (arrays equal)
  as the JAX package's for the same seed, ``Scan3RDataset`` gives the same
  items (val; train with augmentation, whose draws share the dataset's
  generator) and the loaders the same batches (val uncompacted and pooled;
  train shuffled);
* float64 on small shapes against the JAX functions: ``gcn_conv``,
  ``MultiGCN``, ``nca_loss`` / ``overall_nca_loss`` at rtol 1e-12 / atol
  1e-12 (the same f64 sums in another order), and ``EVA`` with random
  weights through the weight bridge, against JAX's unfused PointNet path
  (``pointnet_fused="never"``, what ``"auto"`` resolves to on the CPU: the
  Pallas forward sums f64 inputs in f32), at the same tolerance; the
  PointNet at EVA's C3 = 200 against the Pallas forward (interpret mode)
  at f32, normwise 1e-5;
* the CLIs ``inference_align_reg`` (point, full) and ``inference_align_eva``
  (eva) at f32 on the CPU, on the held-out val workspace each
  ``quality.json`` pins: MRR and Hits@1/3/5 within abs 0.02 of it (the
  JAX package's own test's tolerance), and EVA below full; per batch, the
  same counts (ranks, hits, valid pairs) as the JAX package's
  ``AlignRegTester`` on the same workspace and OCDBT store, the reciprocal
  rank sums and SGAR within abs 1e-4 (f32 sums in another order). The
  tester reads the OCDBT store as it reads the ``.pth.tar`` copy.
"""

import contextlib
import io
import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import jax
import jax.numpy as jnp

from sgaligner_tpu.core import config as jax_config
from sgaligner_tpu.core.checkpoint import torch_state_dict_to_params
from sgaligner_tpu.data import fixtures as jax_fixtures
from sgaligner_tpu.data import loaders as jax_loaders
from sgaligner_tpu.data.scan3r import Scan3RDataset as JaxDataset
from sgaligner_tpu.models.eva import EVA as JaxEVA
from sgaligner_tpu.models.structure import MultiGCN as JaxMultiGCN
from sgaligner_tpu.ops import losses as jax_losses
from sgaligner_tpu.ops import objective as jax_objective
from sgaligner_tpu.ops import pointnet_fused as jpf
from sgaligner_tpu.ops.gat import gcn_conv as jax_gcn_conv
from sgaligner_tpu_torch.core.checkpoint import state_dict_from_flax
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data import fixtures as port_fixtures
from sgaligner_tpu_torch.data import loaders as port_loaders
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
from sgaligner_tpu_torch.data.scan3r import Scan3RDataset
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.models.eva import EVA
from sgaligner_tpu_torch.models.structure import MultiGCN
from sgaligner_tpu_torch.ops.gat import gcn_conv
from sgaligner_tpu_torch.ops.losses import nca_loss
from sgaligner_tpu_torch.ops.objective import overall_nca_loss
from sgaligner_tpu_torch.ops.pointnet_fused import pointnet_fwd
from tests.test_torch_model import jax_inputs, valid_rows
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)

RTOL = ATOL = 1e-12
EVA_MODULES = ("point", "gcn", "rel", "attr")
SPEC_ARGS = dict(batch_size=3, max_objects=10, points_per_object=32)
TRAIN_WS = dict(n_pairs=4, n_shared=5, n_extra=3, pts_per_obj=64,
                pc_resolutions=[32, 64], view_noise=0.05, bow_flip=0.25,
                proto_classes=2, center_noise=0.5)


# ----------------------------------- data -----------------------------------

def _assert_equal(got, want, what):
    """Nested dicts / lists / arrays equal, dtypes of arrays too."""
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), what
        for k in want:
            _assert_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _workspace_files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """The benchmark's val workspace and a small train one, written by the
    port and by the JAX package from the same seeds."""
    out = {}
    for side, mod in (("port", port_fixtures), ("jax", jax_fixtures)):
        root = str(tmp_path_factory.mktemp(f"ws_{side}"))
        info = mod.make_synthetic_workspace(
            osp.join(root, "val"), split="val", n_pairs=smoke.N_VAL_PAIRS,
            seed=smoke.VAL_SEED, **smoke.BENCH)
        # the fixtures name scans by pair, so each split has a root of its own
        train = mod.make_synthetic_workspace(osp.join(root, "train"), split="train",
                                             seed=3, **TRAIN_WS)
        # get_train_val_data_loader opens a val split beside the train one
        files = osp.join(root, "train", "files", "orig")
        shutil.copy(osp.join(files, "anchors_train.json"),
                    osp.join(files, "anchors_val.json"))
        out[side] = (root, info, train)
    return out


def test_workspace_matches_jax(workspaces):
    import pickle

    (p_root, p_info, p_train), (j_root, j_info, j_train) = (
        workspaces["port"], workspaces["jax"])
    _assert_equal(p_info, j_info, "val info")
    _assert_equal(p_train, j_train, "train info")
    files = _workspace_files(j_root)
    assert _workspace_files(p_root) == files and len(files) > 100
    for rel in files:
        got, want = osp.join(p_root, rel), osp.join(j_root, rel)
        if rel.endswith(".npy"):
            _assert_equal(np.load(got), np.load(want), rel)
        elif rel.endswith(".pkl"):
            with open(got, "rb") as fg, open(want, "rb") as fw:
                _assert_equal(pickle.load(fg), pickle.load(fw), rel)
        else:
            with open(got) as fg, open(want) as fw:
                assert fg.read() == fw.read(), rel


def _cfgs(root, split, **tpu):
    values = smoke.quality_cfg(osp.join(root, split), ["point", "gat", "rel", "attr"])
    values["tpu"].update(tpu)
    values["train"].update(batch_size=3, pc_res=32, augmentation_active=True)
    values["num_workers"] = 1
    return make_cfg(**values), jax_config.make_cfg(**values)


def test_dataset_items_match_jax(workspaces):
    root = workspaces["port"][0]
    for split in ("val", "train"):
        port_cfg, jax_cfg = _cfgs(root, split)
        port_ds, jax_ds = Scan3RDataset(port_cfg, split), JaxDataset(jax_cfg, split)
        assert len(port_ds) == len(jax_ds) > 0
        for i in range(len(jax_ds)):
            _assert_equal(port_ds[i], jax_ds[i], f"{split}[{i}]")
        assert port_ds.pair_scan_ids(1) == jax_ds.pair_scan_ids(1)
        np.testing.assert_array_equal(port_ds.pair_gt_transform(0),
                                      jax_ds.pair_gt_transform(0))


@pytest.mark.parametrize("bucket", [0, 128])
def test_loader_batches_match_jax(workspaces, bucket):
    """Val: in order, two reading threads, the last batch short; train:
    shuffled and dropping the last partial batch, one thread (its items
    draw from the dataset's generator in the order they are read)."""
    root = workspaces["port"][0]
    port_cfg, jax_cfg = _cfgs(root, "val", pooled_bucket=bucket)
    port_cfg.num_workers = jax_cfg.num_workers = 2
    port_val, jax_val = (port_loaders.get_val_dataloader(port_cfg),
                         jax_loaders.get_val_dataloader(jax_cfg))
    got, want = list(port_val), list(jax_val)
    assert len(got) == len(want) == len(port_val) == 4
    _assert_equal(got, want, "val")
    assert ("obj_points_pooled" in got[0]) == (bucket > 0)
    port_cfg, jax_cfg = _cfgs(root, "train", pooled_bucket=bucket)
    port_train, _ = port_loaders.get_train_val_data_loader(port_cfg)
    jax_train, _ = jax_loaders.get_train_val_data_loader(jax_cfg)
    for epoch in range(2):
        _assert_equal(list(port_train), list(jax_train), f"train epoch {epoch}")


def test_loader_raises_for_what_is_not_ported(workspaces):
    root = workspaces["port"][0]
    for tpu in ({"dp": 2}, {"compact_slots": 32}):
        cfg, _ = _cfgs(root, "val", **tpu)
        with pytest.raises(NotImplementedError):
            port_loaders.get_val_dataloader(cfg)


# ------------------------------- EVA at f64 ---------------------------------

def _graph(seed, g=4, n=9, din=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, n, din))
    adj = rng.random((g, n, n)) < 0.3
    mask = np.ones((g, n), bool)
    mask[0, 6:] = False
    mask[2, 1:] = False                      # one node alone
    mask[3] = False                          # an empty graph
    adj &= mask[:, None, :] & mask[:, :, None]
    return x, adj, mask


def test_gcn_conv_matches_jax_f64(x64):
    x, adj, mask = _graph(1)
    rng = np.random.default_rng(2)
    w, b = rng.normal(size=(3, 7)), rng.normal(size=7)
    want = expect_dtype(jax_gcn_conv(*expect_dtype([jnp.asarray(x), jnp.asarray(adj),
                                                    jnp.asarray(mask)]),
                                     *expect_dtype([jnp.asarray(w), jnp.asarray(b)])))
    t = torch.from_numpy
    got = gcn_conv(t(x), t(adj), t(mask), t(w), t(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[3].any() and not got[0, 6:].any()


def test_multigcn_matches_jax_f64(x64):
    x, adj, mask = _graph(3)
    jm = JaxMultiGCN((3, 20, 40), dtype=jnp.float64)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(adj),
                        jnp.asarray(mask))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                          variables["params"])
    want = expect_dtype(jm.apply({"params": jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), params)},
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mask)))
    model = MultiGCN((3, 20, 40))
    model.load_state_dict({k.removeprefix("structure_encoder."): v for k, v in
                           state_dict_from_flax({"structure_encoder": params}, None,
                                                ("gcn",)).items()})
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(adj),
                           torch.from_numpy(mask))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _eva_weights():
    """Random upstream-layout EVA weights, and the flax tree the JAX
    package's importer makes of them."""
    rng = np.random.default_rng(6)
    sd = {k: torch.from_numpy((rng.normal(size=v.shape) / np.sqrt(
        v.shape[1] if v.dim() > 1 else 10.0)).astype(np.float32))
        for k, v in EVA(EVA_MODULES).state_dict().items()}
    params, stats = torch_state_dict_to_params(sd, EVA_MODULES)
    assert stats == {}
    return sd, params


@pytest.mark.parametrize("layout", ["pooled", "padded"])
def test_eva_forward_and_nca_loss_match_jax_f64(x64, layout):
    batch = make_synthetic_batch(BatchSpec(**SPEC_ARGS), seed=5, bow_noise=0.3)
    if layout == "pooled":
        batch = pool_compact(batch, 16)
    sd, params = _eva_weights()
    back = state_dict_from_flax(params, None, EVA_MODULES)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert sd["object_encoder.conv3.weight"].shape == (200, 128, 1)
    model = EVA(EVA_MODULES, dtype=torch.float64)
    model.load_state_dict(back, strict=True)
    with torch.inference_mode():
        got = model(to_device(batch, "cpu"))
        got_loss = overall_nca_loss(got, to_device(batch, "cpu"))
    jb = jax_inputs(batch)
    jax_model = JaxEVA(modules=EVA_MODULES, pointnet_fused="never", dtype=jnp.float64)
    want = expect_dtype(jax.jit(lambda p, b: jax_model.apply({"params": p}, b))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params), jb))
    assert sorted(got) == sorted(want) == sorted((*EVA_MODULES, "joint"))
    for m in want:
        assert got[m].dtype == torch.float64
        np.testing.assert_allclose(valid_rows(batch, got[m].numpy()),
                                   valid_rows(batch, want[m]), rtol=RTOL, atol=ATOL,
                                   err_msg=m)
    want_loss = expect_dtype(jax.jit(jax_objective.overall_nca_loss)(want, jb))
    assert sorted(got_loss) == sorted(want_loss)
    for k in want_loss:
        np.testing.assert_allclose(float(got_loss[k]), float(want_loss[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_eva_compacted_layout_raises():
    spec = BatchSpec(**SPEC_ARGS, compact_slots=20)
    batch = to_device(make_synthetic_batch(spec, seed=1), "cpu")
    with pytest.raises(NotImplementedError):
        EVA(EVA_MODULES)(batch)


@pytest.mark.parametrize("alpha,beta,ep", [(1.0, 1.0, 0.0), (0.5, 2.0, 0.1)])
def test_nca_loss_matches_jax_f64(x64, alpha, beta, ep):
    rng = np.random.default_rng(8)
    src, ref = rng.normal(size=(6, 5)), rng.normal(size=(6, 5))
    mask = np.array([1, 1, 0, 1, 1, 0], bool)
    want = expect_dtype(jax_losses.nca_loss(jnp.asarray(src), jnp.asarray(ref),
                                            jnp.asarray(mask), alpha, beta, ep))
    got = nca_loss(torch.from_numpy(src), torch.from_numpy(ref),
                   torch.from_numpy(mask), alpha, beta, ep)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", [32, 70])
def test_pointnet_at_eva_width_matches_jax(x64, p):
    """C3 = 200: f64 against the unfused path; f32 against the Pallas
    forward in interpret mode (it takes the 200-wide output block)."""
    rng = np.random.default_rng(p)
    x = rng.normal(size=(16, 3, p))
    ws = []
    for cin, cout in ((3, 64), (64, 128), (128, 200)):
        ws += [rng.normal(size=(cin, cout)) / np.sqrt(cin), rng.normal(size=(1, cout)) * 0.1]
    t = [torch.from_numpy(a) for a in (x, *ws)]
    got64, _ = pointnet_fwd(*t)
    want64 = expect_dtype(jpf._unfused(*(jnp.asarray(a) for a in (x, *ws))))
    np.testing.assert_allclose(got64.numpy(), np.asarray(want64), rtol=RTOL, atol=ATOL)
    assert jpf._pick_tile(16, p, 4, bwd=False) is not None   # the Pallas kernel runs
    got32, amax = pointnet_fwd(*(a.float() for a in t), with_argmax=True)
    want32, amax_j = jpf._forward(*(jnp.asarray(a, jnp.float32) for a in (x, *ws)),
                                  True, with_argmax=True)
    want32 = np.asarray(want32)
    assert got32.shape == want32.shape == (16, 200)
    err = np.abs(got32.numpy() - want32).max() / np.abs(want32).max()
    assert err <= 1e-5, err
    np.testing.assert_array_equal(amax.numpy(), np.asarray(amax_j))


# ------------------------- the trained snapshots ----------------------------

def _counts(out):
    """One eval step's metric components (a dict of torch tensors or of
    JAX arrays) as float64 numpy."""
    def arr(v):
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)

    got = {k: arr(out[k]) for k in ("rr_sum", "rr_count", "pair_valid")}
    got.update({f"sgar@{m}": arr(v) for m, v in out["sgar"].items()})
    got.update({k: np.stack([arr(c) for c in v]) for k, v in out.items()
                if k.startswith("hits@")})
    return got


def _recording(make, log):
    """A ``make_eval_step`` whose steps append their counts to ``log``."""
    def make_recording(*args, **kw):
        step = make(*args, **kw)

        def recorded(*a):
            out = step(*a)
            log.append(_counts(out))
            return out
        return recorded
    return make_recording


@pytest.fixture(scope="module")
def quality_runs(tmp_path_factory):
    """Each snapshot's CLI at f32 on the CPU: {name: (results, config
    path, per-batch counts)}."""
    import yaml

    from sgaligner_tpu_torch.cli import inference_align_eva, inference_align_reg
    from sgaligner_tpu_torch.engine import tester

    tmp = tmp_path_factory.mktemp("quality")
    built, out = {}, {}
    for name in smoke.SNAPSHOTS:
        q = smoke.snapshot_quality(name)
        key = json.dumps([q["bench"], q["val_seed"], q["n_val_pairs"]])
        if key not in built:
            built[key] = str(tmp / f"ws{len(built)}")
            smoke.build_val_workspace(built[key], q)
        model_name = q.get("model_name", "sgaligner")
        cfg_path = str(tmp / f"cfg_{name}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(smoke.quality_cfg(built[key], q["modules"], model_name), f)
        cli = inference_align_eva if model_name == "eva" else inference_align_reg
        buf, log = io.StringIO(), []
        with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
            mp.setattr(tester, "make_eval_step", _recording(tester.make_eval_step, log))
            rc = cli.main(["--config", cfg_path, "--snapshot",
                           smoke.torch_snapshot(name), "--output_root",
                           str(tmp / "out"), "--device", "cpu"])
        assert rc == 0
        out[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]), cfg_path, log)
    return out


@pytest.mark.parametrize("name", smoke.SNAPSHOTS)
def test_cli_meets_quality_json(quality_runs, name):
    got = quality_runs[name][0]
    pinned = smoke.snapshot_quality(name)["results"]
    assert sorted(got) == sorted(pinned)
    for k in smoke.QUALITY_KEYS:
        assert got[k] == pytest.approx(pinned[k], abs=smoke.QUALITY_ABS), (
            f"{name}:{k} {got[k]:.4f} vs pinned {pinned[k]:.4f}")


def test_eva_below_full(quality_runs):
    eva, full = quality_runs["eva"][0], quality_runs["full"][0]
    assert eva["mrr"] < full["mrr"] and eva["hits@1"] < full["hits@1"]


@pytest.mark.parametrize("name", smoke.SNAPSHOTS)
def test_tester_counts_match_jax(quality_runs, name):
    """The JAX package's tester on the same workspace, config and OCDBT
    store: per batch the same ranks counted, hits and valid pairs, the
    reciprocal rank sums and SGAR within abs 1e-4."""
    from sgaligner_tpu.engine import tester as jax_tester

    got_results, cfg_path, got = quality_runs[name]
    cfg = jax_config.update_config(jax_config.make_cfg(), cfg_path, ensure_dir=False)
    cfg.registration = False
    loader = jax_loaders.get_val_dataloader(cfg)
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tester, "make_eval_step",
                   _recording(jax_tester.make_eval_step, want))
        want_results = jax_tester.AlignRegTester(
            cfg, loader.dataset, loader,
            snapshot=osp.join(smoke.CHECKPOINTS, f"aligner_{name}")).run()
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "rr_sum" or k.startswith("sgar"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4,
                                           err_msg=f"{name} batch {i} {k}")
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} batch {i} {k}")
    assert sorted(got_results) == sorted(want_results)
    for k in want_results:
        assert got_results[k] == pytest.approx(want_results[k], abs=1e-4), k


def test_tester_reads_the_store_as_the_copy(quality_runs, tmp_path):
    """The OCDBT store (the reader's route) gives EVA's results bit for bit;
    registration in the config without an evaluator leaves the alignment
    metrics as they were (as the JAX tester); the GeoTransformer backend,
    which is not ported, raises, and so do the learned backend given a
    --reg_snapshot that holds no geo_params and the classical backend given
    one at all, since it takes none; the card without one raises."""
    import yaml

    from sgaligner_tpu_torch.cli import inference_align_reg
    from sgaligner_tpu_torch.core.config import update_config
    from sgaligner_tpu_torch.engine.tester import AlignRegTester

    want, cfg_path, _ = quality_runs["eva"]
    cfg = update_config(make_cfg(), cfg_path, ensure_dir=False)
    loader = port_loaders.get_val_dataloader(cfg)
    store = osp.join(smoke.CHECKPOINTS, "aligner_eva")
    tester = AlignRegTester(cfg, loader.dataset, loader, snapshot=store, device="cpu")
    assert tester.run() == want
    assert (tester.epoch, tester.iteration) == (18, 216)
    cfg.registration = True
    assert AlignRegTester(cfg, loader.dataset, loader, snapshot=store,
                          device="cpu").run() == want
    cfg.registration = False
    with open(cfg_path) as f:
        values = yaml.safe_load(f)
    for backend, reg_snapshot, error in (("learned", store, FileNotFoundError),
                                         ("geotransformer", store, NotImplementedError),
                                         ("ransac", store, ValueError)):
        path = str(tmp_path / f"{backend}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dict(values, registration=True,
                                reg_model={"backend": backend}), f)
        argv = ["--config", path, "--snapshot", store, "--device", "cpu"]
        with pytest.raises(error):
            inference_align_reg.main(argv + (["--reg_snapshot", reg_snapshot]
                                             if reg_snapshot else []))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            AlignRegTester(cfg, loader.dataset, loader, snapshot=store)
