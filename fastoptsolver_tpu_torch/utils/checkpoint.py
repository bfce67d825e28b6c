"""Checkpoint / resume for solver-state pytrees (port of
``fastoptsolver_tpu/utils/checkpoint.py``), in the reference's file format.

Any state (``FusedSolveState``, ``VmemSolveState``, ``ResidentSolveState``,
``BatchState``, a ``GramBatch``, a ``DenseGram``, a ``SolveResult``, …) is
flattened with torch's pytree (NamedTuples natively; the frozen dataclasses
are registered in field order, ``utils.pytree``) to one ``.npz`` holding the
leaves keyed ``leaf_000…``, written atomically. A restore takes an example
pytree of the same structure and validates the leaf count and shapes.

So a file written by the JAX package restores here and the reverse, for the
states both packages share, whose fields match in order:

- ``None`` fields (``SolveResult.history``, ``BatchResult.failed``) are no
  leaf on either side: JAX drops them, and so does this module;
- each restored leaf takes the dtype and device of the example's leaf (a
  checkpoint restores straight onto the card), and a Python number in the
  example (the port's ``BatchState.k`` is an ``int``) comes back as one.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.utils._pytree as _pytree


def _flatten(tree):
    """(the leaves that are not None, the positions they hold among all
    leaves, every leaf, the spec)."""
    leaves, spec = _pytree.tree_flatten(tree)
    slots = [i for i, leaf in enumerate(leaves) if leaf is not None]
    return [leaves[i] for i in slots], slots, leaves, spec


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, example):
    """``arr`` as the example's kind: a tensor of its dtype and device, a
    NumPy array of its dtype, or a Python number of its type."""
    if isinstance(example, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=example.dtype, device=example.device)
    if isinstance(example, (bool, int, float)):
        return type(example)(arr.item())
    return np.asarray(arr, dtype=np.asarray(example).dtype)


def save_pytree(path: str, tree) -> str:
    """Serialize a pytree of tensors/arrays to ``path`` (``.npz`` appended
    if missing). Returns the file path written."""
    leaves = _flatten(tree)[0]
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"leaf_{i:03d}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint
    return path


def restore_pytree(path: str, example):
    """Restore a pytree saved by :func:`save_pytree` (or by the JAX
    package's) into the structure of ``example`` (same tree; leaf count and
    shapes validated, dtypes and devices taken from the example)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    ex_leaves, slots, leaves, spec = _flatten(example)
    with np.load(path) as data:
        keys = sorted(data.files)
        if len(keys) != len(ex_leaves):
            raise ValueError(
                f"checkpoint {path} has {len(keys)} leaves; example pytree has "
                f"{len(ex_leaves)}"
            )
        for key, i, ex in zip(keys, slots, ex_leaves):
            arr = data[key]
            ex_shape = tuple(ex.shape) if isinstance(ex, torch.Tensor) else np.shape(ex)
            if arr.shape != ex_shape:
                raise ValueError(
                    f"checkpoint leaf {key} shape {arr.shape} != example "
                    f"{ex_shape}"
                )
            leaves[i] = _like(arr, ex)
    return _pytree.tree_unflatten(leaves, spec)
