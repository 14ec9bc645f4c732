"""Checkpoint and resume for optimisation loops.

PyTorch port of mitsuba_customization_tpu/utils/checkpoint.py, with its
file layout: a directory holding `state.npz` (the leaves `leaf_0`,
`leaf_1`, ... as numpy arrays) and `meta.json` (step, seed, leaf count,
extra), both written to temporary names and moved into place with
os.replace. The leaves are flattened as jax.tree_util flattens {"opt_state":
opt_state, "params": params}: dicts by sorted key, lists and tuples in
order, None as no leaf, so the optimiser state's leaves come first and the
parameters' last. A params checkpoint written by the JAX package therefore
loads here with equal values, and one written here loads there.

`opt_state` is a torch.optim state_dict (or any tree of tensors, numbers,
strings, lists, tuples and dicts). Its structure is written to meta.json
too, because a fresh optimiser's state_dict has no per-parameter state to
supply the structure on load.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


def _sorted_keys(d):
    return sorted(d, key=lambda k: (type(k).__name__, k))


def _flatten(tree, leaves):
    """Append tree's leaves to `leaves` in jax.tree_util's order; return
    its structure as JSON."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"dict": [[[type(k).__name__, k], _flatten(tree[k], leaves)]
                         for k in _sorted_keys(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, leaves) for v in tree],
                "tuple": isinstance(tree, tuple)}
    if isinstance(tree, str):
        return {"str": tree}
    kind = ("tensor" if torch.is_tensor(tree) else "ndarray"
            if isinstance(tree, np.ndarray) else type(tree).__name__)
    if kind not in ("tensor", "ndarray", "bool", "int", "float"):
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")
    leaves.append(tree.detach().cpu().numpy() if kind == "tensor" else np.asarray(tree))
    return {"leaf": kind}


def _unflatten(skel, leaves):
    """Rebuild a tree from its JSON structure, consuming `leaves` (tensors
    on the CPU, where torch.optim's load_state_dict takes them from)."""
    if skel is None:
        return None
    if "dict" in skel:
        return {(int(k) if t == "int" else k): _unflatten(v, leaves)
                for (t, k), v in skel["dict"]}
    if "list" in skel:
        out = [_unflatten(v, leaves) for v in skel["list"]]
        return tuple(out) if skel["tuple"] else out
    if "str" in skel:
        return skel["str"]
    leaf = leaves.pop(0)
    kind = skel["leaf"]
    if kind == "tensor":
        return torch.as_tensor(leaf)
    if kind == "ndarray":
        return leaf
    return {"bool": bool, "int": int, "float": float}[kind](leaf.item())


def _like(like, leaves):
    """Rebuild `like`'s structure from `leaves`; a tensor takes its like's
    dtype and device."""
    if like is None:
        return None
    if isinstance(like, dict):  # leaves in sorted-key order, keys in like's
        out = {k: _like(like[k], leaves) for k in _sorted_keys(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(v, leaves) for v in like)
    leaf = leaves.pop(0)
    if torch.is_tensor(like):
        return torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
    return leaf


def save_checkpoint(path, step, params, opt_state=None, seed=0, extra=None):
    """Write step, params, opt_state and seed atomically to the directory
    `path`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = []
    opt_skel = _flatten(opt_state, leaves)
    _flatten(params, leaves)
    tmp = path / ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    meta = {
        "step": int(step),
        "seed": int(seed),
        "n_leaves": len(leaves),
        "opt_state": opt_skel,
        "extra": extra or {},
    }
    with open(path / ".tmp.json", "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path / "state.npz")
    os.replace(path / ".tmp.json", path / "meta.json")


def load_checkpoint(path, like_params, like_opt_state=None):
    """Restore (step, params, opt_state, seed). `like_params` supplies the
    parameters' structure, dtypes and devices (they are the file's last
    leaves, so a JAX checkpoint's optax state is passed over);
    `like_opt_state`, when given, the optimiser state's, which otherwise
    comes from meta.json with its tensors on the CPU (None when the file
    has none)."""
    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    with np.load(path / "state.npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    n_opt = len(leaves) - len(_leaf_list(like_params))
    params = _like(like_params, leaves[n_opt:])
    if like_opt_state is not None:
        opt_state = _like(like_opt_state, leaves[:n_opt])
    else:
        opt_state = _unflatten(meta.get("opt_state"), leaves[:n_opt])
    return meta["step"], params, opt_state, meta["seed"]


def _leaf_list(tree):
    out = []
    _flatten(tree, out)
    return out


def latest_step(path):
    """Step of the stored checkpoint, or -1 if none exists."""
    try:
        with open(Path(path) / "meta.json") as f:
            return json.load(f)["step"]
    except (FileNotFoundError, json.JSONDecodeError):
        return -1
