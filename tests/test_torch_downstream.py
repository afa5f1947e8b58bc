"""The port's two downstream tasks against the JAX package's, on the CPU:
overlap detection (``OverlapTester`` through ``cli/inference_find_overlapper``)
and 3D mosaicking (``MosaickTester`` through ``cli/inference_mosaicking``).

Both sides run their CLI on the same ``make_synthetic_workspace`` of 3
overlapping and 3 non-overlapping pairs (each pair two subscans of one
scan), with the tracked ``full`` snapshot and ``reg_model.backend:
learned``, the JAX package's quality contract
(``scripts/downstream_quality.py``) at a small size, the first two scans
mosaicked (upstream's truncation).
Both testers register through the port's learned backend on the tracked
``geo_reg`` weights (``build_backend``'s default; each registration
computed once by the port's run and read again by the JAX one), so the
comparison holds the testers, the CLIs and the evaluator's glue; the backend itself is held
to the JAX package's in ``tests/test_torch_learned_reg.py``, where the
float32 rounding of two libraries' SVDs, amplified by the trimmed ICP of a
wrong registration, keeps two backends from agreeing to 1e-4 on pairs that
do not register. The aligner fit's draws are the JAX package's on both
sides (``jax_draw``) and the JAX evaluator fits at float64 as the port does
(``jax_fit_f64``, under x64). Held: the overlap prediction lists pair by
pair and P/R/F1 equal, the mosaicking metrics within 1e-4.
"""

import contextlib
import io
import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch
import yaml

from sgaligner_tpu_torch.reg import ransac
from tests.test_torch_registration import jax_draw, jax_fit_f64

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SNAPSHOT = osp.join(REPO, "checkpoints", "torch", "aligner_full.pth.tar")
MOSAIC_TOL = 1e-4
MAX_SCANS = 2      # the CLI's default, upstream's truncation


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs six workers on
    the host's cores, and the CPU matcher and ICP would take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _values(root: str) -> dict:
    return dict(model_name="sgaligner", modules=["point", "gat", "rel", "attr"],
                registration=True, data={"subscan_dir": root},
                preprocess={"pc_resolutions": [64], "min_obj_points": 10},
                val={"batch_size": 4, "pc_res": 64},
                tpu={"max_objects": 16, "points_per_object": 64, "dp": 1},
                reg_model={"backend": "learned", "ransac_max_iters": 500})


def _cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def x64_module():
    """float64 JAX for the module (the JAX fit at float64), its caches
    cleared on entry and exit as ``tests.test_torch_ops.x64`` does."""
    jax.clear_caches()
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jax.clear_caches()


class _Replay:
    """The port's learned backend, each registration computed once: the
    port's testers run first and fill the record, the JAX testers then
    read the same results for the same clouds (keyed by their bytes)."""

    def __init__(self, backend):
        self.backend, self.done = backend, {}

    @staticmethod
    def _key(src, ref):
        return (src.shape, src.tobytes(), ref.shape, ref.tobytes())

    def register(self, src, ref, gt_transform=None):
        return self.register_batch([(src, ref)])[0]

    def register_batch(self, pairs):
        todo = [p for p in pairs if self._key(*p) not in self.done]
        for p, out in zip(todo, self.backend.register_batch(todo) if todo else []):
            self.done[self._key(*p)] = out
        return [self.done[self._key(*p)] for p in pairs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, x64_module):
    """Both CLIs on both sides: {side: (overlap results, the lists each
    precision_recall_f1 call saw, mosaicking results)}."""
    from sgaligner_tpu.align import alignment as jalignment
    from sgaligner_tpu.cli import inference_find_overlapper as jover
    from sgaligner_tpu.cli import inference_mosaicking as jmosaic
    from sgaligner_tpu.reg import evaluator as jevaluator
    from sgaligner_tpu_torch.align import alignment
    from sgaligner_tpu_torch.cli import inference_find_overlapper, inference_mosaicking
    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace
    from sgaligner_tpu_torch.reg import backend as port_backend

    tmp = tmp_path_factory.mktemp("downstream")
    root = str(tmp / "ws")
    make_synthetic_workspace(root, split="val", n_pairs=3, n_nonoverlap_pairs=3, seed=5)
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_values(root), f)
    argv = ["--config", cfg_path, "--snapshot", SNAPSHOT,
            "--output_root", str(tmp / "out")]
    replay = {}

    def build(cfg, snap=None, device="cpu"):
        if "backend" not in replay:
            replay["backend"] = _Replay(port_backend.build_backend(cfg, snap, device=device))
        return replay["backend"]

    out = {}
    for side, mods, extra in (("got", (inference_find_overlapper, inference_mosaicking,
                                       alignment), ["--device", "cpu"]),
                              ("want", (jover, jmosaic, jalignment), [])):
        over, mosaic, align_mod = mods
        seen = []
        prf = align_mod.precision_recall_f1

        def recorded(true, pred, prf=prf, seen=seen):
            seen.append((list(true), list(pred)))
            return prf(true, pred)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(align_mod, "precision_recall_f1", recorded)
            mp.setattr(ransac, "draw_minimal_sets", jax_draw)
            mp.setattr(jevaluator, "find_rigid_transform", jax_fit_f64)
            for mod in (over, mosaic):
                mp.setattr(mod, "build_backend", build)
            overlap = _cli(over.main, argv + extra)
            mosaick = _cli(mosaic.main, argv + extra + ["--max_scans", str(MAX_SCANS)])
        out[side] = (overlap, seen, mosaick)
    assert replay["backend"].done, "the port's testers registered nothing"
    return out


def test_overlap_predictions_match_jax(runs):
    """Both score types' truth and prediction lists pair by pair, and the
    P/R/F1 the CLI prints, equal to the JAX package's."""
    got, got_lists, _ = runs["got"]
    want, want_lists, _ = runs["want"]
    assert got_lists == want_lists
    assert got == want
    aligner_true = want_lists[0][0]
    assert len(aligner_true) == 6 and set(aligner_true) == {0.0, 1.0}


def test_mosaicking_matches_jax(runs):
    """Each scan's two subscans merged from the aligner's and from the normal
    registration: accuracy, completion, precision, recall and F-score within
    1e-4 of the JAX package's."""
    got, want = runs["got"][2], runs["want"][2]
    assert sorted(got) == sorted(want) == ["aligner_mosaicking_metrics",
                                           "normal_mosaicking_metrics"]
    for key in want:
        assert got[key].keys() == want[key].keys() and want[key], key
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=0,
                                       atol=MOSAIC_TOL, err_msg=f"{key} {k}")


def test_clis_run_on_the_card_by_default(tmp_path):
    """Without ``--device`` both CLIs ask for the card: on a machine without
    one they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from sgaligner_tpu_torch.cli import inference_find_overlapper, inference_mosaicking
    from sgaligner_tpu_torch.data.fixtures import make_synthetic_workspace

    root = str(tmp_path / "ws")
    make_synthetic_workspace(root, split="val", n_pairs=1, seed=1)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_values(root), f)
    for main in (inference_find_overlapper.main, inference_mosaicking.main):
        with pytest.raises(RuntimeError):
            main(["--config", cfg_path, "--snapshot", SNAPSHOT])
