"""Host <-> device transfers of trees of tensors.

Counterpart of ``radar_slam_tpu/utils/host.py``: a tree-aware fetch to
numpy (:func:`device_get`) and a tree-aware upload to a named device
(:func:`device_put`).  The reference splits complex leaves into real and
imaginary planes to work around its TPU transport; CUDA moves complex64 as
it is, so no split is made here.

A tree is a tensor or array, None, or a tuple, NamedTuple, list or dict of
trees (:func:`tree_map`, :func:`tree_leaves`, :func:`tree_unflatten`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

import numpy as np
import torch

from radar_slam_tpu_torch.core.device import DEFAULT, resolve


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (None kept, structure kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, x) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order (NamedTuple field order, dict
    insertion order), None skipped -- the order ``jax.tree.leaves`` gives
    for the same structure."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` put back into the structure of ``like`` (None kept)."""
    it: Iterator = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            items = [build(x) for x in t]
            if hasattr(t, "_fields"):
                return type(t)(*items)
            return type(t)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _leaf_to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_get(tree: Any) -> Any:
    """Tree-aware host fetch: every tensor leaf as a numpy array."""
    return tree_map(_leaf_to_host, tree)


def device_put(tree: Any, device=DEFAULT) -> Any:
    """Tree-aware upload of numpy (or tensor) leaves to ``device`` (the card
    unless the caller names another), dtypes kept."""
    dev = resolve(device)
    return tree_map(
        lambda x: (x.to(dev) if isinstance(x, torch.Tensor) else
                   torch.from_numpy(np.array(x, order="C")).to(dev)), tree)
