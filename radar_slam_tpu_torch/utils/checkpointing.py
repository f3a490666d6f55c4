"""Pipeline-state checkpointing.

Counterpart of ``radar_slam_tpu/utils/checkpointing.py``, in the same file
layout: ``<stem>.npz`` holds the leaves as ``leaf_0``, ``leaf_1``, ... and
``<stem>.json`` holds ``step``, ``num_leaves`` and ``treedef``.  Leaves are
taken in NamedTuple field order with None fields skipped, the order
``jax.tree.flatten`` gives, and the treedef is written in its notation, so a
``FrameState`` checkpoint of either package has the same leaf order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Tuple

import numpy as np
import torch

from radar_slam_tpu_torch.utils.host import (device_get, tree_leaves,
                                           tree_unflatten)


def treedef_str(tree: Any) -> str:
    """The structure of ``tree`` in ``jax.tree.structure``'s notation."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, (tuple, list)):
            kids = ", ".join(node(x) for x in t)
            if hasattr(t, "_fields"):
                return f"CustomNode(namedtuple[{type(t).__name__}], [{kids}])"
            return f"({kids})" if isinstance(t, tuple) else f"[{kids}]"
        if isinstance(t, dict):
            kids = ", ".join(f"'{k}': {node(v)}" for k, v in t.items())
            return "{" + kids + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"


def save_pytree(path: str | Path, tree: Any, step: int = 0) -> Path:
    """Write ``tree``'s leaves (fetched to the host) and its structure."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = device_get(tree_leaves(tree))
    np.savez(path.with_suffix(".npz"),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    meta = {"step": step, "num_leaves": len(leaves),
            "treedef": treedef_str(tree)}
    path.with_suffix(".json").write_text(json.dumps(meta))
    return path.with_suffix(".npz")


def load_leaves(path: str | Path) -> Tuple[List[np.ndarray], dict]:
    """The leaves of a checkpoint as numpy arrays, in order, and its
    metadata (``step``, ``num_leaves``, ``treedef``)."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if len(leaves) != int(meta["num_leaves"]):
        raise ValueError(f"{path}: {len(leaves)} leaves, metadata says "
                         f"{meta['num_leaves']}")
    return leaves, meta


def load_pytree(path: str | Path, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf onto the device and
    dtype of the template's leaf, shapes checked.  Returns (tree, step)."""
    leaves, meta = load_leaves(path)
    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(like_leaves)}")
    restored = []
    for a, b in zip(leaves, like_leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"shape mismatch {a.shape} vs "
                             f"{tuple(b.shape)}")
        restored.append(torch.from_numpy(np.array(a, order="C")).to(
            device=b.device, dtype=b.dtype))
    return tree_unflatten(like, restored), int(meta["step"])


def latest_checkpoint(directory: str | Path,
                      prefix: str = "state") -> Path | None:
    d = Path(directory)
    if not d.exists():
        return None
    cands = sorted(d.glob(f"{prefix}_*.npz"))
    return cands[-1] if cands else None
