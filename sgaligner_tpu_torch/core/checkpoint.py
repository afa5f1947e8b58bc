"""Snapshots and the weight bridge: the JAX package's parameter tree -> the
port's state_dict.

``read_ocdbt_snapshot(path)`` reads a snapshot the JAX package wrote
(``sgaligner_tpu/core/checkpoint.py::save_snapshot``: an orbax OCDBT store
of zarr arrays, zstd-compressed, plus ``meta.json``) through
``tensorstore``, without JAX: nested dicts of numpy arrays, the counterpart
of that module's ``load_snapshot``. ``load_torch_snapshot`` /
``save_torch_snapshot`` read and write upstream's ``.pth.tar`` layout
``{"model": state_dict, "epoch", "iteration"}``, the one the JAX package's
``load_torch_snapshot`` reads; ``checkpoints/torch/`` holds such copies of
the tracked snapshots (``scripts/export_torch_snapshots.py``), so a machine
without ``tensorstore`` loads them. The trainer writes the same layout:
``epoch-<N>.pth.tar`` and ``best_snapshot.pth.tar``, and the rolling
``snapshot.pth.tar`` with the train state's other entries beside the model
(``engine/train_step.py::TrainState.state_dict``). ``load_model_state``
reads either kind of snapshot into the port's state_dict;
``latest_snapshot`` finds the newest in a snapshot directory.

``state_dict_from_flax(params, batch_stats, modules)`` takes the flax
``params`` / ``batch_stats`` trees of ``sgaligner_tpu``'s MultiModalEncoder
or EVA (as nested dicts of numpy arrays) and returns a state_dict with
upstream SGAligner's torch names and shapes — the port's own parameter
names. It is the inverse of
``sgaligner_tpu/core/checkpoint.py::torch_state_dict_to_params`` for the
point / pct / gat / gcn / rel / attr modules:

* Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
  Conv1d(k=1) weights -> ``[out, in, 1]``;
* MaskedBatchNorm ``scale / bias`` + ``mean / var`` -> ``weight / bias /
  running_mean / running_var``;
* GATConv ``weight [in, H, out]`` -> ``lin_src.weight [H·out, in]``,
  ``att_src / att_dst [H, out]`` -> ``[1, H, out]``;
* GCNConv ``weight [in, out]`` -> ``lin.weight [out, in]``.

The parity-mode PointNet has no BatchNorm (its tree has no
``batch_stats``), and EVA has no ``object_embedding`` or
``structure_embedding``: each is mapped where the tree has it.

``spct_state_dict_from_flax(params, batch_stats)`` maps the tree of a flax
``SPCT`` (``emb0``, ``emb0_bn``, ``emb1``, ``emb1_bn``, ``sa1``..``sa4``,
``linear``, ``linear_bn``) onto the port's ``SPCT``, and the tree of a lone
``OABlock`` (``qk``, ``v``, ``trans``, ``after_norm``) onto the port's
``OABlock``.

``full_pct_state_dict_from_flax(params, batch_stats)`` maps the tree of a
flax ``FullPCT`` onto the port's ``FullPCT``, and
``full_pct_flax_from_state_dict`` maps it back. The JAX checkpoint
converter has no FullPCT entry, so the names are the port's own, upstream
pct.py's where it has them (``_FULL_PCT``):

* ``ne_conv1``, ``ne_conv2``, ``ne_bn1``, ``ne_bn2`` ->
  ``neighbor_embedding.conv1`` / ``conv2`` / ``bn1`` / ``bn2``;
* ``sg1`` / ``sg2`` ``.conv1``, ``.conv2``, ``.bn1``, ``.bn2`` ->
  ``neighbor_embedding.sg1`` / ``sg2`` ``.conv1`` ...;
* ``oa1``..``oa4`` ``qk``, ``v``, ``trans``, ``after_norm`` -> ``oa1``..``oa4``
  ``q_conv``, ``v_conv``, ``trans_conv``, ``after_norm`` (as SPCT's blocks);
* ``linear``, ``linear_bn`` -> ``linear.0``, ``linear.1``; ``linear1``,
  ``bn1``, ``linear2``, ``bn2`` under their own names;

with the running statistics of every BatchNorm.

``geo_state_dict_from_flax(params)`` maps the learned registration
matcher's tree (``checkpoints/geo_reg/geo_params``, read by
``read_ocdbt_tree``, a bare tree without ``meta.json``) onto the port's
``reg.geo_model.GeoRegModel``.

``loss_state_dict_from_flax(params["loss"])`` gives the objective's
(``ops.objective.OverallLoss``) state_dict from the JAX train state's loss
parameters. Leaves come back as float32, or float64 where the tree holds
float64 (so a float64 tree, or its gradients, maps without rounding).
"""

from __future__ import annotations

import ast
import json
import os
import os.path as osp

import numpy as np
import torch


def read_ocdbt_tree(path: str) -> dict:
    """An orbax OCDBT store the JAX package wrote (a snapshot's directory,
    or a bare parameter tree such as ``checkpoints/geo_reg/geo_params``)
    -> its tree as nested dicts of numpy arrays, keyed as saved. Needs
    ``tensorstore``."""
    try:
        import tensorstore as ts
    except ImportError as err:
        raise ImportError(
            "reading an orbax store needs tensorstore; without it, load the "
            ".pth.tar copy in checkpoints/torch/ (written by "
            "scripts/export_torch_snapshots.py)") from err
    path = osp.abspath(path)
    with open(osp.join(path, "_METADATA")) as f:
        keys = [ast.literal_eval(k) for k in json.load(f)["tree_metadata"]]
    out: dict = {}
    for key in keys:
        arr = ts.open({"driver": "zarr",
                       "kvstore": {"driver": "ocdbt", "base": f"file://{path}",
                                   "path": ".".join(key)}}).result()
        node = out
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = np.asarray(arr.read().result())
    return out


def read_ocdbt_snapshot(path: str) -> dict:
    """A JAX-package snapshot directory -> ``{"params": tree, "batch_stats":
    tree (when saved), ..., "epoch", "iteration"}``, every tree a nested
    dict of numpy arrays keyed as the JAX package's ``load_snapshot`` gives
    them (the model under ``params["model"]`` when the train state saved
    its objective's parameters beside it, under ``params["loss"]``).
    Needs ``tensorstore``; a machine without it loads the ``.pth.tar``
    copies instead (``load_torch_snapshot``)."""
    with open(osp.join(osp.abspath(path), "meta.json")) as f:
        meta = json.load(f)
    out = read_ocdbt_tree(path)
    out["epoch"], out["iteration"] = meta["epoch"], meta["iteration"]
    return out


def latest_snapshot(snapshot_dir: str) -> str | None:
    """The newest snapshot under ``snapshot_dir``: the port's rolling
    ``snapshot.pth.tar``, else its ``epoch-<N>.pth.tar`` with the largest
    N, else the JAX package's rolling ``snapshot`` directory, else its
    ``epoch-<N>`` directory with the largest N (that package's
    ``latest_snapshot``)."""
    if not osp.isdir(snapshot_dir):
        return None
    names = os.listdir(snapshot_dir)
    for rolling, suffix in (("snapshot.pth.tar", ".pth.tar"), ("snapshot", "")):
        if rolling in names:
            return osp.join(snapshot_dir, rolling)
        epochs = [n.removesuffix(suffix) for n in names if n.startswith("epoch-")
                  and n.endswith(suffix) and n.removesuffix(suffix)[6:].isdigit()]
        if epochs:
            last = max(epochs, key=lambda n: int(n[6:]))
            return osp.join(snapshot_dir, last + suffix)
    return None


def save_torch_snapshot(path: str, state_dict: dict, epoch: int = 0,
                        iteration: int = 0, **extra) -> str:
    """Write upstream's ``.pth.tar`` layout: ``{"model": state_dict,
    "epoch", "iteration"}``, and ``extra``'s entries beside them (the
    rolling training snapshot's)."""
    torch.save({"model": {k: v.detach().cpu() for k, v in state_dict.items()},
                "epoch": int(epoch), "iteration": int(iteration), **extra}, path)
    return path


def load_torch_snapshot(path: str) -> dict:
    """An upstream ``.pth.tar`` -> ``{"model": state_dict, "epoch",
    "iteration"}`` and the file's other entries. A bare state_dict, or one
    under ``"state_dict"``, is taken too, and DDP's ``module.`` prefix is
    dropped (what the JAX package's ``load_torch_snapshot`` accepts)."""
    if not osp.isfile(path):
        raise FileNotFoundError(f"no snapshot at {path}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in blob or "state_dict" in blob:
        state_dict = blob.get("model", blob.get("state_dict"))
        extra = {k: v for k, v in blob.items()
                 if k not in ("model", "state_dict", "epoch", "iteration")}
    else:
        state_dict, extra = blob, {}
    state_dict = {k.removeprefix("module."): v for k, v in state_dict.items()}
    return {**extra, "model": state_dict, "epoch": int(blob.get("epoch", 0)),
            "iteration": int(blob.get("iteration", 0))}


def load_model_state(path: str, modules: tuple[str, ...]
                     ) -> tuple[dict[str, torch.Tensor], int, int]:
    """A snapshot's model weights as the port's state_dict, with its epoch
    and iteration: a ``.pth.tar`` (``load_torch_snapshot``) or a JAX-package
    snapshot directory (``read_ocdbt_snapshot``, which needs
    ``tensorstore``)."""
    if path.endswith((".pth.tar", ".pth", ".tar")):
        blob = load_torch_snapshot(path)
        return blob["model"], blob["epoch"], blob["iteration"]
    blob = read_ocdbt_snapshot(path)
    params = blob["params"]
    params = params["model"] if "model" in params else params
    state_dict = state_dict_from_flax(params, blob.get("batch_stats"), modules)
    return state_dict, blob["epoch"], blob["iteration"]


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(
        a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


def _conv(kernel) -> torch.Tensor:
    """Dense kernel [in, out] -> Conv1d weight [out, in, 1]."""
    return _t(np.asarray(kernel).T[:, :, None])


def _linear(sd: dict, prefix: str, dense: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        sd[f"{prefix}.bias"] = _t(dense["bias"])


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def _attention_block(sd: dict, pre: str, blk: dict, st: dict) -> None:
    """An SA / OA block's ``qk``, ``v``, ``trans`` and ``after_norm`` under
    the key prefix ``pre`` ("" or ending in ".")."""
    sd[f"{pre}q_conv.weight"] = _conv(blk["qk"]["kernel"])
    sd[f"{pre}v_conv.weight"] = _conv(blk["v"]["kernel"])
    sd[f"{pre}v_conv.bias"] = _t(blk["v"]["bias"])
    sd[f"{pre}trans_conv.weight"] = _conv(blk["trans"]["kernel"])
    sd[f"{pre}trans_conv.bias"] = _t(blk["trans"]["bias"])
    _bn(sd, f"{pre}after_norm", blk["after_norm"], st["after_norm"])


def _pct_trunk(sd: dict, pre: str, enc: dict, st: dict) -> None:
    """The embedding, the four blocks and the 1024-wide linear that NaivePCT
    and SPCT share, under the key prefix ``pre``."""
    for i in (1, 2):
        sd[f"{pre}embedding.conv{i}.weight"] = _conv(enc[f"emb{i - 1}"]["kernel"])
        _bn(sd, f"{pre}embedding.bn{i}", enc[f"emb{i - 1}_bn"], st[f"emb{i - 1}_bn"])
    for s in (1, 2, 3, 4):
        _attention_block(sd, f"{pre}sa{s}.", enc[f"sa{s}"], st[f"sa{s}"])
    sd[f"{pre}linear.0.weight"] = _conv(enc["linear"]["kernel"])
    _bn(sd, f"{pre}linear.1", enc["linear_bn"], st["linear_bn"])


def state_dict_from_flax(params: dict, batch_stats: dict | None,
                         modules: tuple[str, ...]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    batch_stats = batch_stats or {}
    if "pct" in modules:
        enc, st = params["object_encoder"], batch_stats["object_encoder"]
        p = "object_encoder"
        _pct_trunk(sd, f"{p}.", enc, st)
        _linear(sd, f"{p}.linear1", enc["linear1"])
        _bn(sd, f"{p}.bn1", enc["bn1"], st["bn1"])
        _linear(sd, f"{p}.linear2", enc["linear2"])
        _bn(sd, f"{p}.bn2", enc["bn2"], st["bn2"])
    elif "point" in modules:
        enc = params["object_encoder"]
        for i in (1, 2, 3):
            sd[f"object_encoder.conv{i}.weight"] = _conv(enc[f"conv{i}"]["kernel"])
            sd[f"object_encoder.conv{i}.bias"] = _t(enc[f"conv{i}"]["bias"])
    if "object_embedding" in params:
        _linear(sd, "object_embedding", params["object_embedding"])
    if "gcn" in modules:
        se = params["structure_encoder"]
        for i in range(len(se)):
            layer = se[f"gcn{i}"]
            p = f"structure_encoder.layer_stack.{i}"
            sd[f"{p}.lin.weight"] = _t(np.asarray(layer["weight"]).T)
            sd[f"{p}.bias"] = _t(layer["bias"])
    if "gat" in modules:
        se = params["structure_encoder"]
        for i in range(len(se)):
            layer = se[f"gat{i}"]
            w = np.asarray(layer["weight"])                  # [in, H, out]
            din, h, dout = w.shape
            p = f"structure_encoder.layer_stack.{i}"
            sd[f"{p}.lin_src.weight"] = _t(w.transpose(1, 2, 0).reshape(h * dout, din))
            sd[f"{p}.att_src"] = _t(np.asarray(layer["att_src"])[None])
            sd[f"{p}.att_dst"] = _t(np.asarray(layer["att_dst"])[None])
            sd[f"{p}.bias"] = _t(layer["bias"])
        _linear(sd, "structure_embedding", params["structure_embedding"])
    if "rel" in modules:
        _linear(sd, "meta_embedding_rel", params["meta_embedding_rel"])
    if "attr" in modules:
        _linear(sd, "meta_embedding_attr", params["meta_embedding_attr"])
    if "fusion" in params:
        sd["fusion.weight"] = _t(params["fusion"]["weight"])
    return sd


def spct_state_dict_from_flax(params: dict, batch_stats: dict
                              ) -> dict[str, torch.Tensor]:
    """A flax ``SPCT`` tree, or a lone ``OABlock``'s (told apart by its
    ``qk`` entry), -> the port module's state_dict."""
    sd: dict[str, torch.Tensor] = {}
    if "qk" in params:
        _attention_block(sd, "", params, batch_stats)
    else:
        _pct_trunk(sd, "", params, batch_stats)
    return sd


# FullPCT's leaves: (flax path, torch key prefix, kind), kind "conv" (a
# Dense kernel as a Conv1d weight), "linear", "bn" or "block" (an OA block)
_FULL_PCT = (
    ("ne_conv1", "neighbor_embedding.conv1", "conv"),
    ("ne_bn1", "neighbor_embedding.bn1", "bn"),
    ("ne_conv2", "neighbor_embedding.conv2", "conv"),
    ("ne_bn2", "neighbor_embedding.bn2", "bn"),
    *((f"{sg}.{kind}{i}", f"neighbor_embedding.{sg}.{kind}{i}",
       "conv" if kind == "conv" else "bn")
      for sg in ("sg1", "sg2") for i in (1, 2) for kind in ("conv", "bn")),
    *((f"oa{i}", f"oa{i}", "block") for i in (1, 2, 3, 4)),
    ("linear", "linear.0", "conv"),
    ("linear_bn", "linear.1", "bn"),
    ("linear1", "linear1", "linear"),
    ("bn1", "bn1", "bn"),
    ("linear2", "linear2", "linear"),
    ("bn2", "bn2", "bn"),
)


def _node(tree: dict, path: str) -> dict:
    for key in path.split("."):
        tree = tree[key]
    return tree


def _put(tree: dict, path: str, value: dict) -> None:
    *parents, last = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


def full_pct_state_dict_from_flax(params: dict, batch_stats: dict
                                  ) -> dict[str, torch.Tensor]:
    """A flax ``FullPCT`` tree -> the port's ``FullPCT`` state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, pre, kind in _FULL_PCT:
        node = _node(params, path)
        if kind == "conv":
            sd[f"{pre}.weight"] = _conv(node["kernel"])
        elif kind == "linear":
            _linear(sd, pre, node)
        elif kind == "bn":
            _bn(sd, pre, node, _node(batch_stats, path))
        else:
            _attention_block(sd, f"{pre}.", node, _node(batch_stats, path))
    return sd


def full_pct_flax_from_state_dict(sd: dict) -> tuple[dict, dict]:
    """The port's ``FullPCT`` state_dict -> the flax ``(params,
    batch_stats)`` trees (numpy arrays), the inverse of
    ``full_pct_state_dict_from_flax``."""
    params: dict = {}
    stats: dict = {}

    def a(key):
        return sd[key].detach().cpu().numpy()

    def kernel(pre):
        return {"kernel": a(f"{pre}.weight")[:, :, 0].T}

    def bn(pre):
        return ({"scale": a(f"{pre}.weight"), "bias": a(f"{pre}.bias")},
                {"mean": a(f"{pre}.running_mean"), "var": a(f"{pre}.running_var")})

    for path, pre, kind in _FULL_PCT:
        if kind == "conv":
            _put(params, path, kernel(pre))
        elif kind == "linear":
            dense = {"kernel": a(f"{pre}.weight").T}
            if f"{pre}.bias" in sd:
                dense["bias"] = a(f"{pre}.bias")
            _put(params, path, dense)
        elif kind == "bn":
            p, st = bn(pre)
            _put(params, path, p)
            _put(stats, path, st)
        else:
            p, st = bn(f"{pre}.after_norm")
            _put(params, path, {
                "qk": kernel(f"{pre}.q_conv"),
                "v": {**kernel(f"{pre}.v_conv"), "bias": a(f"{pre}.v_conv.bias")},
                "trans": {**kernel(f"{pre}.trans_conv"), "bias": a(f"{pre}.trans_conv.bias")},
                "after_norm": p})
            _put(stats, path, {"after_norm": st})
    return params, stats


def loss_state_dict_from_flax(loss_params: dict) -> dict[str, torch.Tensor]:
    """``{"ial_log_vars": [M], "icl_log_vars": [M]}`` -> the same names as
    the objective's parameters."""
    return {k: _t(loss_params[k]) for k in ("ial_log_vars", "icl_log_vars")}


def geo_state_dict_from_flax(params: dict, prefix: str = ""
                             ) -> dict[str, torch.Tensor]:
    """A flax ``GeoRegModel`` tree (``sgaligner_tpu/reg/geo_model.py``) ->
    the port's ``reg.geo_model.GeoRegModel`` state_dict. The port names its
    submodules as the tree does, so each leaf maps by its path: a Dense
    ``kernel [in, out]`` to ``weight [out, in]``, a LayerNorm ``scale`` to
    ``weight``, ``bias`` as it is, and the four scalars (``inv_temp``,
    ``dustbin``, ``fine_inv_temp``, ``fine_dustbin``) to 0-d tensors."""
    sd: dict[str, torch.Tensor] = {}
    for name, node in params.items():
        key = f"{prefix}{name}"
        if isinstance(node, dict):
            sd.update(geo_state_dict_from_flax(node, f"{key}."))
        elif name == "kernel":
            sd[f"{prefix}weight"] = _t(np.asarray(node).T)
        elif name == "scale":
            sd[f"{prefix}weight"] = _t(node)
        else:
            sd[key] = _t(node)
    return sd
