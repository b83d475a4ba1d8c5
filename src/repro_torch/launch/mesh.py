"""The device mesh of the sharded page pool (port of the pool's part of
``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` and runs the pool's bursts
inside ``shard_map`` over it.  Here a mesh is an explicit list of
``torch.device``s along one named axis (:data:`POOL_AXIS`), and
:mod:`repro_torch.fabric.sharded` runs each shard's part of a burst in
turn, in one process, on lists of per-shard blocks.

In this slice every shard lives on one device: the engine's, or the CPU
in the tests.  The exchange between shards is then a copy on that device.
A mesh over several distinct devices waits for a machine that has them
(ROADMAP §1 item 8c) and raises.  ``make_production_mesh`` and
``make_mesh``, the training meshes, wait for item 8b.

The reference's ``compat_shard_map`` hands each shard its block of every
operand, as the operand's ``PartitionSpec`` splits it, and runs the body
once per shard.  Its pool's part is :func:`shard_blocks`: the per-shard
views of a tensor split along the mesh axis, over which the caller runs
each shard's part of a hop in turn.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

POOL_AXIS = "pool"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s`` of the axis ``axis``."""

    devices: Tuple[torch.device, ...]
    axis: str = POOL_AXIS

    @property
    def size(self) -> int:
        """The number of shards along the axis."""
        return len(self.devices)


def compat_mesh(devices: Sequence, shape: tuple, axes: tuple) -> Mesh:
    """A :class:`Mesh` of ``devices`` laid out as ``shape`` with axis names
    ``axes`` (the reference's signature).  Only a 1-D mesh whose devices
    are all one device is built here."""
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if len(shape) != 1 or len(axes) != 1:
        raise ValueError(f"the pool mesh is 1-D, got shape {tuple(shape)} "
                         f"over axes {tuple(axes)}")
    if shape[0] != len(devs) or not devs:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{len(devs)} devices")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over several devices {sorted(map(str, set(devs)))} is "
            f"ported in a later slice (ROADMAP §1 item 8c): every shard "
            f"shares one device here")
    return Mesh(devs, axes[0])


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the index of the current card, so a mesh device equals
    the device of a tensor allocated there."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_blocks(x: torch.Tensor, spec: Tuple,
                 mesh: Mesh) -> List[torch.Tensor]:
    """The pool's part of the reference's ``compat_shard_map``: the block of
    ``x`` each shard of ``mesh`` holds under the partition ``spec`` (one
    entry per axis, ``mesh.axis`` on the axis that splits, ``None`` on the
    whole ones), as views of ``x`` in shard order.  ``x`` must live on the
    mesh's device and its split axis divide into equal blocks."""
    if x.device != mesh.devices[0]:
        raise ValueError(f"a tensor on {x.device} is not on the pool mesh's "
                         f"device {mesh.devices[0]}")
    axis = tuple(spec).index(mesh.axis)
    if x.shape[axis] % mesh.size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {mesh.size} equal shard blocks")
    return list(x.chunk(mesh.size, dim=axis))
