"""Checkpoint and resume of model and optimizer state.

PyTorch counterpart of the JAX package's ``utils/checkpoint.py``.  A
checkpoint is one ``.npz``: the leaves as arrays (``leaf_0``, ``leaf_1``,
...) beside ``__structure__``, a JSON record of the nesting (dicts with
their keys in order, lists, tuples, None) and of each leaf's kind (tensor,
numpy array, bool, int, float, str).  It is read with
``allow_pickle=False``.  So ``{"model": model.state_dict(), "optimizer":
optimizer.state_dict(), "best": ...}`` round-trips, Adam's per-parameter
``step``, ``exp_avg`` and ``exp_avg_sq`` and its ``param_groups``
included.

bf16 tensors are stored as f32 (numpy has no bf16) and restored to the
dtype of ``like``'s leaf, as are all tensors, on that leaf's device.
Orbax, the JAX package's other format, is JAX's and has no counterpart
here: ``use_orbax=True`` raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "optimizer_state_like"]

_SCALARS = ((bool, "bool"), (int, "int"), (float, "float"), (str, "str"))


def _flatten(tree, leaves: list):
    """The JSON-able structure record of ``tree``; appends its leaves to
    ``leaves`` in order."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "tensor"
    if isinstance(tree, (np.ndarray, np.generic)):
        leaves.append(tree)
        return "array"
    for kind, name in _SCALARS:   # bool before int: a bool is an int
        if isinstance(tree, kind):
            leaves.append(tree)
            return name
    if isinstance(tree, dict):
        for key in tree:
            if isinstance(key, bool) or not isinstance(key, (str, int)):
                raise TypeError(f"checkpoint dict keys must be str or int, got {key!r}")
        return {"dict": [[k, _flatten(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple":
                [_flatten(v, leaves) for v in tree]}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(structure, leaves):
    """Rebuild a tree from its structure record and an iterator of leaves."""
    if structure is None:
        return None
    if isinstance(structure, str):
        return next(leaves)
    (kind, items), = structure.items()
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in items}
    out = [_unflatten(v, leaves) for v in items]
    return out if kind == "list" else tuple(out)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype.is_floating_point and t.dtype not in (torch.float16, torch.float32,
                                                        torch.float64):
            # numpy has no bf16 (nor f8): upcast losslessly; the load casts back.
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _restore(saved: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(saved)).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.generic):
        return saved.astype(like.dtype)[()]
    if isinstance(like, np.ndarray):
        return saved.astype(like.dtype)
    return type(like)(saved.item())


def _file_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: Any, *, use_orbax: Optional[bool] = None) -> str:
    """Write ``state`` (nested dicts / lists / tuples of tensors, numpy
    arrays and Python scalars) to ``path`` (``.npz`` appended unless it is
    there); returns the file's path.  The file is written beside and then
    renamed, so a reader never sees half of it."""
    if use_orbax:
        raise RuntimeError(
            "use_orbax=True: orbax is JAX's checkpointer and has no counterpart "
            "in the port, which writes npz (use_orbax=None or False)")
    leaves: list = []
    structure = _flatten(state, leaves)
    file_path = _file_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    tmp = f"{file_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, __structure__=np.frombuffer(json.dumps(structure).encode(), np.uint8),
                 **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})
    os.replace(tmp, file_path)
    return file_path


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore a checkpoint into the structure of ``like``: each tensor
    leaf with the dtype and on the device of ``like``'s, each numpy leaf
    with its dtype, each scalar as its type.  A saved structure that
    differs from ``like``'s raises and names both."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint?); the port "
                         "reads the npz checkpoints that save_checkpoint writes")
    like_leaves: list = []
    want = json.dumps(_flatten(like, like_leaves))
    with np.load(_file_path(path), allow_pickle=False) as npz:
        saved = bytes(npz["__structure__"]).decode()
        if saved != want:
            raise ValueError(
                "Checkpoint structure does not match `like`: restoring by leaf "
                "index would silently reassign arrays to the wrong fields.\n"
                f"  saved: {saved}\n  like:  {want}")
        leaves = [_restore(npz[f"leaf_{i}"], leaf) for i, leaf in enumerate(like_leaves)]
    return _unflatten(json.loads(want), iter(leaves))


def optimizer_state_like(optimizer: torch.optim.Optimizer) -> dict:
    """The ``state_dict`` that ``optimizer`` (Adam or AdamW) will have
    once each of its parameters has taken a step, with zeros for its
    state: the ``like`` that restores a stepped optimizer's state into a
    fresh one, whose own ``state_dict`` holds no state yet (PyTorch makes
    it at the first step)."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"optimizer_state_like knows Adam and AdamW, got "
                        f"{type(optimizer).__name__}")
    sd = optimizer.state_dict()
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            on_device = group["capturable"] or group["fused"]
            entry = {"step": torch.zeros((), dtype=torch.float32 if group["fused"] else scalar,
                                         device=p.device if on_device else "cpu"),
                     "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                     "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
            if group["amsgrad"]:
                entry["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state[index] = entry
            index += 1
    sd["state"] = state
    return sd
