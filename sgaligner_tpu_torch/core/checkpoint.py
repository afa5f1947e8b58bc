"""Weight bridge: the JAX package's parameter tree -> the port's state_dict.

``state_dict_from_flax(params, batch_stats, modules)`` takes the flax
``params`` / ``batch_stats`` trees of ``sgaligner_tpu``'s MultiModalEncoder
(as nested dicts of numpy arrays) and returns a state_dict with upstream
SGAligner's torch names and shapes — the port's own parameter names. It is
the inverse of ``sgaligner_tpu/core/checkpoint.py::torch_state_dict_to_params``
for the point / pct / gat / rel / attr modules:

* Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
  Conv1d(k=1) weights -> ``[out, in, 1]``;
* MaskedBatchNorm ``scale / bias`` + ``mean / var`` -> ``weight / bias /
  running_mean / running_var``;
* GATConv ``weight [in, H, out]`` -> ``lin_src.weight [H·out, in]``,
  ``att_src / att_dst [H, out]`` -> ``[1, H, out]``.

``loss_state_dict_from_flax(params["loss"])`` gives the objective's
(``ops.objective.OverallLoss``) state_dict from the JAX train state's loss
parameters. Leaves come back as float32, or float64 where the tree holds
float64 (so a float64 tree, or its gradients, maps without rounding).
"""

from __future__ import annotations

import numpy as np
import torch


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


def state_dict_from_flax(params: dict, batch_stats: dict,
                         modules: tuple[str, ...]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    if "pct" in modules:
        enc, st = params["object_encoder"], batch_stats["object_encoder"]
        p = "object_encoder"
        for i in (1, 2):
            sd[f"{p}.embedding.conv{i}.weight"] = _conv(enc[f"emb{i - 1}"]["kernel"])
            _bn(sd, f"{p}.embedding.bn{i}", enc[f"emb{i - 1}_bn"], st[f"emb{i - 1}_bn"])
        for s in (1, 2, 3, 4):
            sa, sa_st = enc[f"sa{s}"], st[f"sa{s}"]
            q = f"{p}.sa{s}"
            sd[f"{q}.q_conv.weight"] = _conv(sa["qk"]["kernel"])
            sd[f"{q}.v_conv.weight"] = _conv(sa["v"]["kernel"])
            sd[f"{q}.v_conv.bias"] = _t(sa["v"]["bias"])
            sd[f"{q}.trans_conv.weight"] = _conv(sa["trans"]["kernel"])
            sd[f"{q}.trans_conv.bias"] = _t(sa["trans"]["bias"])
            _bn(sd, f"{q}.after_norm", sa["after_norm"], sa_st["after_norm"])
        sd[f"{p}.linear.0.weight"] = _conv(enc["linear"]["kernel"])
        _bn(sd, f"{p}.linear.1", enc["linear_bn"], st["linear_bn"])
        _linear(sd, f"{p}.linear1", enc["linear1"])
        _bn(sd, f"{p}.bn1", enc["bn1"], st["bn1"])
        _linear(sd, f"{p}.linear2", enc["linear2"])
        _bn(sd, f"{p}.bn2", enc["bn2"], st["bn2"])
    elif "point" in modules:
        enc = params["object_encoder"]
        for i in (1, 2, 3):
            sd[f"object_encoder.conv{i}.weight"] = _conv(enc[f"conv{i}"]["kernel"])
            sd[f"object_encoder.conv{i}.bias"] = _t(enc[f"conv{i}"]["bias"])
    if "pct" in modules or "point" in modules:
        _linear(sd, "object_embedding", params["object_embedding"])
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


def loss_state_dict_from_flax(loss_params: dict) -> dict[str, torch.Tensor]:
    """``{"ial_log_vars": [M], "icl_log_vars": [M]}`` -> the same names as
    the objective's parameters."""
    return {k: _t(loss_params[k]) for k in ("ial_log_vars", "icl_log_vars")}
