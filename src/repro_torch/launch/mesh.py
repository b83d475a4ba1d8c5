"""Device meshes (port of ``repro.launch.mesh``): the sharded page
pool's 1-D mesh and the training meshes.

The reference builds a ``jax.sharding.Mesh`` over that many devices and
runs its bodies inside ``shard_map``.  Here a mesh is a grid of
``torch.device``s with named axes, and the callers run each rank's part
in turn, in one process, on lists of per-rank blocks
(:mod:`repro_torch.fabric.sharded`, :mod:`repro_torch.launch.steps`).

Every position of a mesh is the run's one device: the card, or the CPU
in the tests.  The exchange between ranks is then a copy on that device.
A mesh over several distinct devices waits for a machine that has them
(ROADMAP §1 item 8c) and raises.  :func:`make_production_mesh` lays the
reference's (16, 16) and (2, 16, 16) meshes over one device, where the
reference needs 256 or 512 devices and raises with fewer.

The reference's ``compat_shard_map`` hands each shard its block of every
operand, as the operand's ``PartitionSpec`` splits it, and runs the body
once per shard.  Its pool's part is :func:`shard_blocks`: the per-shard
views of a tensor split along the mesh axis, over which the caller runs
each shard's part of a hop in turn.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch import resolve_device

POOL_AXIS = "pool"


class DeviceGrid(tuple):
    """A mesh's devices, flat in row-major order, with the mesh's
    ``shape`` (as the reference's ``mesh.devices`` grid has)."""

    def __new__(cls, devices, shape: Tuple[int, ...]):
        grid = super().__new__(cls, devices)
        grid.shape = tuple(shape)
        return grid


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of named axes: ``devices`` is the grid of its positions (one
    device at each), ``axis_names`` names its axes in order."""

    devices: DeviceGrid
    axis_names: Tuple[str, ...] = (POOL_AXIS,)

    @property
    def axis(self) -> str:
        """The one axis of a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"mesh over axes {self.axis_names} is not 1-D")
        return self.axis_names[0]

    @property
    def size(self) -> int:
        """The number of positions (shards, ranks) of the mesh."""
        return len(self.devices)


def compat_mesh(devices: Sequence, shape: tuple, axes: tuple) -> Mesh:
    """A :class:`Mesh` of ``devices`` laid out as ``shape`` with axis names
    ``axes`` (the reference's signature).  Only a mesh whose devices are
    all one device is built here."""
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes) or not shape:
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if math.prod(shape) != len(devs) or not devs:
        raise ValueError(f"mesh shape {shape} does not hold "
                         f"{len(devs)} devices")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over several devices {sorted(map(str, set(devs)))} is "
            f"ported in a later slice (ROADMAP §1 item 8c): every shard "
            f"shares one device here")
    return Mesh(DeviceGrid(devs, shape), axes)


def make_mesh(shape: tuple, axes: tuple, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose every position is ``device``
    (``cuda`` unless the caller asks for the CPU; ``meta`` gives the axis
    sizes alone): the reference's parametric mesh, laid over one device."""
    dev = resolve_device(device)
    return compat_mesh([dev] * math.prod(shape), shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh over one device: (data=16,
    model=16), or with ``multi_pod`` (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


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


# NVIDIA H100 SXM hardware constants used by the roofline analysis
# (:mod:`repro_torch.launch.hlo_analysis`; NVIDIA's data sheet, dense
# rates at the 700 W power limit): the reference's names, the card's values.
PEAK_FLOPS_BF16 = 989.4e12        # bf16 on the tensor cores, per card
PEAK_FLOPS_FP32 = 66.9e12         # float32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s per card
# NVLink 4, bytes/s a direction per card.  On one card the port's
# exchanges are device copies (every mesh position is the one device),
# so this term prices what a mesh over several cards would send.
LINK_BW = 450e9
