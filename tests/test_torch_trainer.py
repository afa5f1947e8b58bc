"""The port's trainer path against the JAX package, on the CPU: the
``Trainer``, its ``.pth.tar`` snapshots and resume, gradient accumulation,
the nca train step, row 15's padding and the training CLIs.

* (a) ``Trainer`` at f64 on a tiny Scan3R workspace (8 train pairs, batch
  2, 8 slots, P = 32), 2 epochs, dropout 0, both sides' own loaders (equal
  batches, ``tests/test_torch_eval.py``), the JAX side's weights (cast to
  f64) carried to the port by ``state_dict_from_flax``. JAX's
  ``build_model`` builds f32 or bf16 only, so the test hands its
  ``Trainer`` an f64 model with ``pointnet_fused="never"``. Each epoch's
  train losses and val summary (loss, MRR, Hits@k, SGAR) within rtol
  1e-10, the same best-snapshot epoch, the final parameters within rtol
  1e-9 / atol 1e-12 (``tests/test_torch_training.py``'s rule);
* (b) ``grad_acc_steps = 2`` against the JAX chain ``apply_if_finite(
  MultiSteps(...))`` over four batches, one of them non-finite: parameters,
  the accumulated gradient and the counters after every step;
* (c) three nca (EVA) train steps against JAX ``make_train_step(kind=
  "nca")`` at f64;
* (d) resume, in the port alone: fixed batch lists and GAT dropout 0.5 (the
  generator's state matters), a 2 + 1 epoch run equals a 3-epoch run bit
  for bit in the parameters, Adam's state, the generator, the accumulated
  gradient and the counters; a non-finite batch through the Trainer (the
  step dropped, the batch and weights dumped); the epoch-2 profile;
* (e) row 15's bf16 ``padded_bwd`` through the plain backward at C3 = 200 and
  100 equals the plain backward at those widths;
* (f) ``trainval_sgaligner`` / ``trainval_eva`` with ``--device cpu`` on a
  YAML config, ``--resume``, ``--snapshot``, and the inference CLIs finding
  the ``.pth.tar`` files (``--test_epoch`` and the newest snapshot).
"""

import contextlib
import io
import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sgaligner_tpu.engine.trainer as jax_trainer
from sgaligner_tpu.core.config import make_cfg as jax_make_cfg
from sgaligner_tpu.data import loaders as jax_loaders
from sgaligner_tpu.engine.factory import build_optimizer as jax_build_optimizer
from sgaligner_tpu.engine.train_step import TrainState as JaxTrainState
from sgaligner_tpu.engine.train_step import make_train_step as jax_train_step
from sgaligner_tpu.models.eva import EVA as JaxEVA
from sgaligner_tpu.models.sg_aligner import MultiModalEncoder as JaxEncoder
from sgaligner_tpu.ops.objective import init_loss_params
from sgaligner_tpu_torch.cli import (inference_align_eva, inference_align_reg,
                                     trainval_eva, trainval_sgaligner)
from sgaligner_tpu_torch.core.checkpoint import (latest_snapshot, load_torch_snapshot,
                                                 loss_state_dict_from_flax,
                                                 state_dict_from_flax)
from sgaligner_tpu_torch.core.config import make_cfg
from sgaligner_tpu_torch.data import loaders as port_loaders
from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact, to_device
from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.train_step import create_train_state, make_train_step
from sgaligner_tpu_torch.engine.trainer import Trainer
from sgaligner_tpu_torch.models.eva import EVA
from sgaligner_tpu_torch.models.sg_aligner import MultiModalEncoder
from sgaligner_tpu_torch.ops.objective import OverallLoss, OverallNCALoss
from sgaligner_tpu_torch.ops.pointnet_fused import (BWD_MULTIPLE, padded_bwd,
                                                    pointnet_bwd_plain,
                                                    pointnet_pool_plain)
from tests.test_torch_model import jax_inputs
from tests.test_torch_ops import expect_dtype, x64  # noqa: F401  (fixture)
from tests.test_torch_training import jax_side  # noqa: F401  (fixture)
from tests.test_torch_training import BUCKET, SPEC, WIDTHS, _batch

POINT = ("point", "gat", "rel", "attr")
EVA_MODULES = ("point", "gcn", "rel", "attr")
P, SLOTS = 32, 8
WORKSPACE = dict(n_shared=4, n_extra=3, pts_per_obj=48, pc_resolutions=[P],
                 view_noise=0.05, bow_flip=0.25, proto_classes=2, center_noise=0.5)
LOSS_RTOL = 1e-10
PARAM_TOL = (1e-9, 1e-12)
CONFIGS = [("sgaligner", POINT), ("eva", EVA_MODULES)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A train split of 8 pairs and a val split of 4 under one root (the
    val split's scans replace train pairs 0-3's, as in the artifact
    script's workspace; both sides read the same files)."""
    root = str(tmp_path_factory.mktemp("trainer_ws"))
    make_synthetic_workspace(root, split="train", n_pairs=8, seed=3, **WORKSPACE)
    make_synthetic_workspace(root, split="val", n_pairs=4, seed=4, **WORKSPACE)
    return root


def _values(root, model_name, modules, epochs=2, dropout=0.0, **optim):
    model = ({"dropout": dropout} if model_name == "eva"
             else dict(WIDTHS, hidden_units=list(WIDTHS["hidden_units"]),
                       heads=list(WIDTHS["heads"]), dropout=dropout))
    return {"seed": 42, "num_workers": 1, "model_name": model_name,
            "modules": list(modules),
            "data": {"name": "Scan3R", "subscan_dir": root},
            "preprocess": {"pc_resolutions": [P], "min_obj_points": 10},
            "train": {"batch_size": 2, "pc_res": P},
            "val": {"batch_size": 2, "pc_res": P},
            "model": model, "optim": {"max_epoch": epochs, **optim},
            "tpu": {"max_objects": SLOTS, "points_per_object": P, "dp": 1}}


def _jax_f64_model(cfg, platform=None):
    """The JAX model of ``cfg`` at f64 on its plain PointNet path."""
    if cfg.model_name == "eva":
        return JaxEVA(modules=tuple(cfg.modules), dropout=cfg.model.dropout,
                      pointnet_fused="never", dtype=jnp.float64)
    return JaxEncoder(modules=tuple(cfg.modules), pt_out_dim=cfg.model.pt_out_dim,
                      emb_dim=cfg.model.emb_dim, hidden_units=tuple(cfg.model.hidden_units),
                      heads=tuple(cfg.model.heads), dropout=cfg.model.dropout,
                      pointnet_fused="never", dtype=jnp.float64)


def _jit_create_train_state(model, tx, batch, loss_params, rng):
    """JAX's ``create_train_state`` with its ``model.init`` jitted (10 s
    eagerly at f64 on a CPU, under 1 s jitted) and the parameters cast to
    f64 before the optimizer's state is made."""
    init_rng, state_rng = jax.random.split(rng)
    variables = jax.jit(model.init, static_argnames="train")(init_rng, batch, train=False)
    params = _as_f64({"model": variables["params"], "loss": loss_params})
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), batch_stats={}, rng=state_rng)


def _as_f64(tree):
    """float32-exact float64 leaves (the port loads the same values)."""
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_named(model, objective):
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out.update({f"loss.{k}": v.detach().clone() for k, v in objective.state_dict().items()})
    return out


def _jax_named(params, modules, with_loss=True):
    expect_dtype(params, what="JAX parameters")
    out = dict(state_dict_from_flax(_np(params["model"]), {}, modules))
    if with_loss:
        out.update({f"loss.{k}": v for k, v in
                    loss_state_dict_from_flax(_np(params["loss"])).items()})
    return out


def _assert_named_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=f"{what}: {k}")


# ---------------------------------- (a) -------------------------------------

@pytest.mark.parametrize("model_name,modules", CONFIGS, ids=["point", "eva"])
def test_trainer_matches_jax_f64(x64, workspace, tmp_path, monkeypatch, model_name,
                                 modules):
    values = _values(workspace, model_name, modules)
    monkeypatch.setattr(jax_trainer, "build_model", _jax_f64_model)
    monkeypatch.setattr(jax_trainer, "create_train_state", _jit_create_train_state)
    jcfg = jax_make_cfg(**values)
    jcfg.snapshot_dir = str(tmp_path / "jax")
    os.makedirs(jcfg.snapshot_dir)
    jtrain, jval = jax_loaders.get_train_val_data_loader(jcfg)
    jt = jax_trainer.Trainer(jcfg, lambda: iter(jtrain), lambda: iter(jval))
    jt.init_state(next(iter(jval)))
    params = jt.state.params

    pcfg = make_cfg(**values)
    pcfg.tpu.compute_dtype = "float64"
    pcfg.snapshot_dir = str(tmp_path / "port")
    os.makedirs(pcfg.snapshot_dir)
    ptrain, pval = port_loaders.get_train_val_data_loader(pcfg)
    pt = Trainer(pcfg, lambda: iter(ptrain), lambda: iter(pval), device="cpu")
    pt.model.double()
    pt.objective.double()
    pt.model.load_state_dict(state_dict_from_flax(_np(params["model"]), {}, modules))
    nca = model_name == "eva"
    if not nca:
        pt.objective.load_state_dict(loss_state_dict_from_flax(_np(params["loss"])))
    pt.init_state()

    want, got = jt.run(), pt.run()
    assert got["epochs"] == want["epochs"] == 2
    for g, w in zip(got["history"], want["history"]):
        keys = sorted(k for k in w["train"] if not k.startswith("time/"))
        assert keys == sorted(k for k in g["train"] if not k.startswith("time/"))
        assert len(keys) == (6 if nca else 4), keys
        for k in keys:
            np.testing.assert_allclose(g["train"][k], w["train"][k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {w['epoch']} train {k}")
        assert sorted(g["val"]) == sorted(w["val"])
        for k, v in w["val"].items():
            np.testing.assert_allclose(g["val"][k], v, rtol=LOSS_RTOL,
                                       err_msg=f"epoch {w['epoch']} val {k}")

    with open(osp.join(jcfg.snapshot_dir, "best_snapshot", "meta.json")) as f:
        jax_best = json.load(f)
    port_best = load_torch_snapshot(osp.join(pcfg.snapshot_dir, "best_snapshot.pth.tar"))
    assert (port_best["epoch"], port_best["iteration"]) == (jax_best["epoch"],
                                                           jax_best["iteration"])
    assert pt.state.step == int(jt.state.step) == 8
    _assert_named_close(_port_named(pt.model, pt.objective),
                        _jax_named(jt.state.params, modules, with_loss=not nca),
                        PARAM_TOL, "parameters after 2 epochs")


# ---------------------------------- (b) -------------------------------------

@pytest.mark.parametrize("jax_side", ["never"], indirect=True)
def test_grad_accumulation_matches_multisteps(jax_side):
    side = jax_side
    values = {"modules": list(POINT), "optim": {"grad_acc_steps": 2}}
    tx = jax_build_optimizer(jax_make_cfg(**values))
    jstep = jax_train_step(side["model"], tx, POINT)
    params = jax.tree.map(jnp.copy, side["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, rng=jax.random.key(1))

    model = MultiModalEncoder(POINT, dtype=torch.float64, **WIDTHS).double()
    model.load_state_dict(state_dict_from_flax(_np(params["model"]), {}, POINT))
    objective = OverallLoss(POINT).double()
    objective.load_state_dict(loss_state_dict_from_flax(_np(params["loss"])))
    port = create_train_state(model, make_cfg(**values), objective)
    step = make_train_step(POINT)
    names = [*(k for k, _ in model.named_parameters()),
             *(f"loss.{k}" for k, _ in objective.named_parameters())]

    # accumulate, dropped (NaN), update, accumulate
    batches = [_batch(3), _batch(4, nan_anchor=True), _batch(5), _batch(6)]
    counts = [(1, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]   # (mini, updates, skipped)
    for i, (host, want_counts) in enumerate(zip(batches, counts)):
        jstate, _ = jstep(jstate, jax_inputs(host))
        step(port, to_device(host, "cpu"))
        inner = jstate.opt_state.inner_state
        got_counts = (port.mini, port.updates, port.skipped)
        assert got_counts == want_counts, i
        assert (int(inner.mini_step), int(inner.gradient_step),
                int(jstate.opt_state.total_notfinite)) == want_counts, i
        assert port.step == int(jstate.step) == i + 1
        _assert_named_close(_port_named(model, objective), _jax_named(jstate.params, POINT),
                            PARAM_TOL, f"parameters after step {i}")
        _assert_named_close(dict(zip(names, port.acc)), _jax_named(inner.acc_grads, POINT),
                            PARAM_TOL, f"accumulated gradient after step {i}")


# ---------------------------------- (c) -------------------------------------

def test_nca_train_steps_match_jax_f64(x64):
    batches = [pool_compact(make_synthetic_batch(SPEC, seed=s, bow_noise=1.0,
                                                 resample=True), BUCKET)
               for s in (3, 4, 5)]
    model = JaxEVA(modules=EVA_MODULES, pointnet_fused="never", dtype=jnp.float64)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.key(0), jax_inputs(batches[0]), train=False)
    rng = np.random.default_rng(5)

    def perturb(path, a):
        a = np.asarray(a, np.float64)
        if "bias" in jax.tree_util.keystr(path) or "fusion" in jax.tree_util.keystr(path):
            a = a + rng.normal(size=a.shape) * 0.05
        return jnp.asarray(a.astype(np.float32), jnp.float64)

    params = {"model": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
              "loss": _as_f64(init_loss_params(len(EVA_MODULES)))}
    values = {"modules": list(EVA_MODULES), "model_name": "eva"}
    tx = jax_build_optimizer(jax_make_cfg(**values))
    jstep = jax_train_step(model, tx, EVA_MODULES, kind="nca")
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, rng=jax.random.key(1))

    port_model = EVA(EVA_MODULES, dtype=torch.float64).double()
    port_model.load_state_dict(state_dict_from_flax(_np(params["model"]), {}, EVA_MODULES))
    port = create_train_state(port_model, make_cfg(**values),
                              OverallNCALoss(EVA_MODULES).double())
    step = make_train_step(EVA_MODULES)
    for i, host in enumerate(batches):
        jstate, want = jstep(jstate, jax_inputs(host))
        got = step(port, to_device(host, "cpu"))
        assert sorted(got) == sorted(want) == sorted(["loss", "joint", *EVA_MODULES])
        for k, v in want.items():
            np.testing.assert_allclose(got[k].item(), float(expect_dtype(v)),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}: {k}")
        _assert_named_close(_port_named(port_model, port.objective),
                            _jax_named(jstate.params, EVA_MODULES, with_loss=False),
                            PARAM_TOL, f"parameters after step {i}")
    assert (port.step, port.updates, port.skipped) == (3, 3, 0)


# ---------------------------------- (d) -------------------------------------

def _fixed_trainer(snapshot_dir, epochs, acc, nan_point=False):
    """The point config with GAT dropout 0.5 over fixed batch lists (3 train
    batches an epoch, so accumulation over 2 straddles epochs); with
    ``nan_point`` the second train batch holds a NaN point of an anchor."""
    cfg = make_cfg(**_values("", "sgaligner", POINT, epochs=epochs, dropout=0.5,
                             grad_acc_steps=acc))
    cfg.snapshot_dir = snapshot_dir
    cfg.output_dir = snapshot_dir
    os.makedirs(snapshot_dir, exist_ok=True)
    spec = BatchSpec(batch_size=2, max_objects=SLOTS, points_per_object=P)
    hosts = [make_synthetic_batch(spec, seed=s, bow_noise=1.0) for s in range(3)]
    if nan_point:
        hosts[1]["obj_points"][0, hosts[1]["e1i"][0, 0], 0, 0] = np.nan
    train = [pool_compact(h, BUCKET) for h in hosts]
    val = [pool_compact(make_synthetic_batch(spec, seed=100 + s), BUCKET) for s in range(2)]
    trainer = Trainer(cfg, lambda: iter(train), lambda: iter(val), device="cpu")
    trainer.init_state()
    return trainer


@pytest.mark.parametrize("acc", [1, 2])
def test_resume_equals_an_uninterrupted_run(tmp_path, acc):
    whole = _fixed_trainer(str(tmp_path / "whole"), 3, acc)
    whole.profile_dir = str(tmp_path / "profile")
    whole.run()
    assert osp.isfile(osp.join(whole.profile_dir, "epoch-2.json"))
    first = _fixed_trainer(str(tmp_path / "split"), 2, acc)
    first.run()
    second = _fixed_trainer(str(tmp_path / "split"), 3, acc)
    assert second.resume() and second.epoch == 2
    second.run()
    a, b = whole.state, second.state
    assert (a.updates, a.skipped, a.mini, a.step) == (b.updates, b.skipped, b.mini, b.step)
    assert a.step == 9 and a.updates == 9 // acc and a.mini == 9 % acc
    for (k, v), w in zip(whole.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(v, w), k
    opt_a, opt_b = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert opt_a["state"].keys() == opt_b["state"].keys()
    for i, st in opt_a["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(opt_b["state"][i][k])), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert (a.acc is None) == (b.acc is None) == (acc == 1)
    for x, y in zip(a.acc or [], b.acc or []):
        assert torch.equal(x, y)
    # the snapshot's parameters moved from the seeded start
    assert not torch.equal(first.model.state_dict()["fusion.weight"],
                           _fixed_trainer(str(tmp_path / "fresh"), 1, acc)
                           .model.state_dict()["fusion.weight"])


def test_nonfinite_batch_through_the_trainer(tmp_path):
    """A batch with a NaN point: the train step drops it (parameters and
    Adam untouched, ``skipped`` counts it), the epoch's loss reads NaN, the
    Trainer dumps the batch and the weights, and training goes on."""
    trainer = _fixed_trainer(str(tmp_path / "nan"), 2, 1, nan_point=True)
    history = trainer.run()["history"]
    assert (trainer.state.updates, trainer.state.skipped) == (4, 2)
    assert all(np.isnan(e["train"]["loss"]) for e in history)
    assert all(np.isfinite(e["val"]["loss"]) for e in history)
    for epoch in (1, 2):
        dump = torch.load(osp.join(str(tmp_path / "nan"), f"nan_debug_e{epoch}_i1.pth"),
                          weights_only=True)
        assert bool(dump["batch"]["obj_points_pooled"].isnan().any())
        assert dump["model"].keys() == trainer.model.state_dict().keys()
    assert all(bool(p.isfinite().all()) for p in trainer.state.parameters())


# ---------------------------------- (e) -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("c3", [200, 100])
def test_padded_backward_equals_the_plain_backward(c3, dtype):
    """``padded_bwd`` (what the card's wrapper runs around its bf16 kernel) with
    the plain backward in the kernels' place: the zero channels carry no
    gradient, so it equals the plain backward at C3 itself (the padded sums
    add exact zeros: rtol 1e-12 at f64, 1e-6 at f32)."""
    rng = np.random.default_rng(c3)
    o, p = 9, 40

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).to(dtype)

    ws = []
    for cin, cout in ((3, 64), (64, 128), (128, c3)):
        ws += [t(cin, cout, scale=cin ** -0.5), t(1, cout, scale=0.1)]
    x = t(o, 3, p)
    peak, amax = pointnet_pool_plain(x, *ws, with_argmax=True)
    assert bool((peak <= 0).any()) and bool((peak > 0).any())
    dout = t(o, c3)
    width = -(-c3 // BWD_MULTIPLE) * BWD_MULTIPLE
    assert width > c3
    got = padded_bwd(pointnet_bwd_plain, width, x, dout, amax, peak, *ws)
    want = pointnet_bwd_plain(x, dout, amax, peak, *ws)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * float(w.abs().max()))


# ---------------------------------- (f) -------------------------------------

def _write_yaml(path, values):
    lines = []

    def emit(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                lines.append(" " * indent + f"{k}:")
                emit(v, indent + 2)
            else:
                lines.append(" " * indent + f"{k}: {json.dumps(v)}")

    emit(values, 0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _infer(cli, cfg_path, out, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--config", cfg_path, "--output_root", out, "--device", "cpu",
                         *extra]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("model_name,modules,train_cli,infer_cli",
                         [("sgaligner", POINT, trainval_sgaligner, inference_align_reg),
                          ("eva", EVA_MODULES, trainval_eva, inference_align_eva)],
                         ids=["sgaligner", "eva"])
def test_training_clis(workspace, tmp_path, monkeypatch, model_name, modules, train_cli,
                       infer_cli):
    """Without ``torch.utils.tensorboard`` (made unimportable here) the
    Trainer runs with no event writer."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "out")
    cfg2 = _write_yaml(tmp_path / "cfg2.yaml", _values(workspace, model_name, modules))
    cfg3 = _write_yaml(tmp_path / "cfg3.yaml",
                       _values(workspace, model_name, modules, epochs=3))
    args = ["--output_root", out, "--device", "cpu"]
    assert train_cli.main(["--config", cfg2, *args]) == 0
    run_dir = osp.join(out, "output", "Scan3R", model_name, "_".join(modules))
    snaps = osp.join(run_dir, "snapshots")
    assert sorted(os.listdir(snaps)) == ["best_snapshot.pth.tar", "epoch-1.pth.tar",
                                         "epoch-2.pth.tar", "snapshot.pth.tar"]
    assert load_torch_snapshot(osp.join(snaps, "snapshot.pth.tar"))["iteration"] == 8

    # --resume goes on from epoch 2 to the raised max_epoch
    assert train_cli.main(["--config", cfg3, "--resume", *args]) == 0
    rolling = load_torch_snapshot(osp.join(snaps, "snapshot.pth.tar"))
    assert (rolling["epoch"], rolling["iteration"]) == (3, 12)
    assert osp.isfile(osp.join(snaps, "epoch-3.pth.tar"))
    with open(osp.join(run_dir, "logs", "train.log")) as f:
        assert "resumed from" in f.read()

    # --snapshot loads a .pth.tar's weights before training
    other = str(tmp_path / "other")
    assert train_cli.main(["--config", cfg2, "--output_root", other, "--device", "cpu",
                           "--snapshot", osp.join(snaps, "epoch-1.pth.tar")]) == 0
    with open(osp.join(other, "output", "Scan3R", model_name, "_".join(modules), "logs",
                       "train.log")) as f:
        assert "loaded pretrained model from" in f.read()

    # the inference CLIs find the .pth.tar files
    assert latest_snapshot(snaps) == osp.join(snaps, "snapshot.pth.tar")
    by_epoch = _infer(infer_cli, cfg3, out, "--test_epoch", "2")
    assert by_epoch == _infer(infer_cli, cfg3, out, "--snapshot",
                              osp.join(snaps, "epoch-2.pth.tar"))
    newest = _infer(infer_cli, cfg3, out)
    assert newest == _infer(infer_cli, cfg3, out, "--snapshot",
                            osp.join(snaps, "snapshot.pth.tar"))
    assert 0.0 < newest["mrr"] <= 1.0 and "hits@1" in newest
    with pytest.raises(FileNotFoundError):
        _infer(infer_cli, cfg3, out, "--test_epoch", "7")
