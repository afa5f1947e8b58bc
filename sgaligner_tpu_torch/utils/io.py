"""File IO helpers: pickle / json / vocabulary readers and the structured
``data.npy`` point-cloud layout.

A copy of ``sgaligner_tpu/utils/io.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_eval.py`` holds the workspace written
through it array-equal to the JAX package's.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def load_pkl_data(filename: str) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)


def write_pkl_data(data: Any, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def load_json(filename: str) -> Any:
    with open(filename) as f:
        return json.load(f)


def write_json(data: Any, filename: str) -> None:
    with open(filename, "w") as f:
        json.dump(data, f)


def name2idx(filename: str) -> dict[str, int]:
    """Line-indexed vocabulary file (common.py name2idx; used for
    relationships.txt -> 41-entry relation vocab)."""
    out: dict[str, int] = {}
    with open(filename) as f:
        for idx, line in enumerate(f):
            name = line.strip()
            if name:
                out[name] = idx
    return out


def get_scan_ids(dirname: str, split: str) -> np.ndarray:
    """Reference utils/scan3r.py:7-10."""
    return np.atleast_1d(
        np.genfromtxt(os.path.join(dirname, f"{split}_scans.txt"), dtype=str))


def load_plydata_npy(file_path: str, obj_ids=None, return_ply_data: bool = False):
    """Structured data.npy loader with objectId filtering (scan3r.py:98-114).

    Record dtype: x,y,z f4; red,green,blue u1; objectId,globalId i2;
    NYU40,Eigen13,RIO27 u1 (verified on the reference example_data).
    """
    ply_data = np.load(file_path)
    points = np.stack([ply_data["x"], ply_data["y"], ply_data["z"]]).T

    if obj_ids is not None:
        if isinstance(obj_ids, np.ndarray):
            mask = np.isin(ply_data["objectId"], obj_ids)
            points = points[np.where(mask)[0]]
        else:
            points = points[np.where(ply_data["objectId"] == obj_ids)[0]]

    return (points, ply_data) if return_ply_data else points


PLY_NPY_DTYPE = np.dtype([
    ("x", "f4"), ("y", "f4"), ("z", "f4"),
    ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ("objectId", "i2"), ("globalId", "i2"),
    ("NYU40", "u1"), ("Eigen13", "u1"), ("RIO27", "u1"),
])


def make_ply_npy(points: np.ndarray, object_ids: np.ndarray,
                 global_ids: np.ndarray | None = None) -> np.ndarray:
    """Build a structured data.npy record array in the reference layout."""
    n = len(points)
    rec = np.zeros(n, dtype=PLY_NPY_DTYPE)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    rec["objectId"] = object_ids.astype("i2")
    rec["globalId"] = (global_ids if global_ids is not None else object_ids).astype("i2")
    return rec
