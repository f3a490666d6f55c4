"""The mesh axis as the ranks of a ``torch.distributed`` process group.

Counterpart of ``radar_slam_tpu/parallel/mesh.py``.  The reference lays a
1-D ``jax.sharding.Mesh`` over devices and runs SPMD programs on it with
``shard_map``.  Here one process (rank) drives one device, and the axis is
the ranks of a process group:

- ``shard_map``'s ``in_specs=P(axis)``: rank r takes the contiguous block
  ``[r*B, (r+1)*B)`` of the axis (:meth:`Mesh.block`, the counterpart of
  ``frame_sharding``);
- ``out_specs=P(axis)`` and ``P()``: the blocks are gathered, so every rank
  holds the whole axis (:meth:`Mesh.gather`, the counterpart of
  ``replicated``);
- ``psum``: :meth:`Mesh.all_reduce` (a sum over ranks).

Without a process group (or at ``n_devices=1``) the mesh is this process
alone, ``make_mesh(1)``: one block, and every collective is the identity.
Tensors stay on their device: with NCCL the collectives run on the card's
stream; with gloo on CUDA tensors (ranks sharing one card) gloo stages
them through the host itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.utils.host import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks of ``group`` (None: the world group),
    this process's ``rank`` on it, and the ``device`` it drives.  At size 1
    the mesh is this process alone and makes no collective."""
    group: Optional[Any]
    size: int
    rank: int
    device: torch.device

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length ``n``; ``n``
        must be a multiple of the mesh size (pad upstream, as the
        reference's shard_map requires)."""
        if n % self.size:
            raise ValueError(f"axis of {n} does not split into {self.size} "
                             f"equal blocks; pad to a multiple "
                             f"(pad_frames_to_devices)")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def take(self, tree: Any) -> Any:
        """This rank's block of the leading axis of every tensor of
        ``tree``."""
        rows = self.block(tree_leaves(tree)[0].shape[0])
        return tree_map(lambda x: x[rows], tree)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor; ``x`` itself on
        a one-rank mesh)."""
        if self.size == 1:
            return x
        y = x.clone()
        dist.all_reduce(y, group=self.group)
        return y

    def gather(self, tree: Any) -> Any:
        """Every rank's blocks concatenated along the leading axis, for
        each tensor of ``tree`` (equal shapes on every rank)."""
        if self.size == 1:
            return tree
        return tree_map(self._gather_one, tree)

    def _gather_one(self, x: torch.Tensor) -> torch.Tensor:
        # Collectives move real words: bool as uint8, complex as its
        # (re, im) pairs.
        y = x
        if x.dtype == torch.bool:
            y = x.to(torch.uint8)
        elif x.is_complex():
            y = torch.view_as_real(x)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        out = torch.cat(parts)
        if x.dtype == torch.bool:
            return out.bool()
        if x.is_complex():
            return torch.view_as_complex(out)
        return out


def make_mesh(n_devices: Optional[int] = None, group=None,
              device=DEFAULT) -> Mesh:
    """A mesh over the ranks of ``group`` (default: the world group).

    Without an initialized process group, or at ``n_devices=1``, the
    one-rank mesh of this process.  ``n_devices`` must otherwise equal the
    group's size; it raises where it exceeds it (reference :22-24).
    ``device`` is the device this rank drives (the card by default)."""
    dev = resolve(device)
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices is not None and n_devices > 1:
            raise ValueError(f"requested {n_devices} devices, have 1 (no "
                             f"process group is initialized)")
        return Mesh(None, 1, 0, dev)
    world = dist.get_world_size(group)
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n == 1:
        return Mesh(None, 1, 0, dev)
    if n != world:
        raise ValueError(f"requested {n} of {world} ranks: pass a group "
                         f"of {n} ranks (torch.distributed.new_group)")
    return Mesh(group, world, dist.get_rank(group), dev)


def pad_frames_to_devices(n_frames: int, n_devices: int) -> int:
    """Frames per device after padding to divisibility."""
    return -(-n_frames // n_devices)
