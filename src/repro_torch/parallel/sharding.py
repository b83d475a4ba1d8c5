"""Logical-axis sharding (port of ``repro.parallel.sharding``): the one
place mesh layout decisions live.

Model code names the logical axes of a tensor (``shard(x, "batch",
"seq", "d_model")``); a :class:`Sharder` maps logical names to mesh axes
through a rules table.  A spec is a plain tuple, one entry per leading
dimension: ``None`` (whole), an axis name, or a tuple of axis names; the
trailing ``None``s are dropped, so it equals ``tuple(PartitionSpec(...))``
of the reference.

Four profiles (:func:`rules_for`):

* ``tp_heads`` — DP x TP: batch over (pod, data); heads, d_ff, vocab and
  experts over model.  Default for every arch.
* ``sp_seq`` — sequence parallelism: the sequence over model for
  activations (an arch whose head count cannot split the model axis).
* ``moe_cap`` — experts whole, the capacity axis over model (granite: 40
  experts on a 16-way axis).
* ``ep_2d`` — experts over model and the capacity over (pod, data).

Every rank of a port mesh lives on the run's one device, so a constraint
moves nothing: :meth:`Sharder.shard` checks the rank and returns the
tensor itself.  The port's models call no ``shard`` (ROADMAP §3); the
specs are what the step builders of :mod:`repro_torch.launch.steps`
record and split batches by.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple, Union

import torch

Axis = Union[None, str, tuple]
Spec = Tuple[Axis, ...]

LOGICAL_RULES_TP = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_model": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "inner": "model",            # mamba d_inner / rg-lru width
    "state": None,
    "conv": None,
    "frames": None,
    "patches": None,
}

LOGICAL_RULES_SP = dict(LOGICAL_RULES_TP, **{
    "heads": None,
    "kv_heads": None,
    "seq": "model",
    "kv_seq": "model",
})

# MoE archs whose expert count cannot split the model axis (granite: 40e on
# a 16-way axis): shard the capacity dim instead, sequence-parallel attention
LOGICAL_RULES_MOE_CAP = dict(LOGICAL_RULES_SP, **{
    "experts": None,
    "expert_cap": "model",
})

# 2-D expert parallelism: experts over model and token capacity over data
LOGICAL_RULES_EP_2D = dict(LOGICAL_RULES_SP, **{
    "experts": "model",
    "expert_cap": ("pod", "data"),
})

_PROFILES = {"tp_heads": LOGICAL_RULES_TP, "sp_seq": LOGICAL_RULES_SP,
             "moe_cap": LOGICAL_RULES_MOE_CAP, "ep_2d": LOGICAL_RULES_EP_2D}


def rules_for(profile: str) -> dict:
    if profile not in _PROFILES:
        raise ValueError(f"unknown sharding profile {profile!r}")
    return dict(_PROFILES[profile])


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (one with ``axis_names`` and a
    ``devices`` grid with a ``shape``, as the reference's)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass
class Sharder:
    mesh: object
    rules: dict

    def spec(self, *logical: Optional[str]) -> Spec:
        """The spec of the logical axes, no divisibility check."""
        return self._spec_from_axes(
            [self.rules.get(name) if name else None for name in logical])

    def safe_spec(self, shape, logical) -> Spec:
        """:meth:`spec` that drops axes a dimension cannot divide.

        When a rule maps to an axis tuple (batch → (pod, data)) and only a
        prefix divides, the longest divisible prefix is kept: batch=256 on
        a (pod=2, data=16) mesh shards 32-way, batch=2 over pod alone.  An
        axis of size 1 divides nothing (it is dropped)."""
        sizes = axis_sizes(self.mesh)
        kept = []
        for dim, name in zip(shape, logical):
            ax = self.rules.get(name) if name else None
            if ax is not None:
                flat = (ax,) if isinstance(ax, str) else tuple(ax)
                flat = tuple(a for a in flat if a in self.mesh.axis_names)
                while flat:
                    total = math.prod(sizes[a] for a in flat)
                    if dim % total == 0 and total > 1:
                        break
                    flat = flat[:-1]
                ax = flat if flat else None
            kept.append(ax)
        return self._spec_from_axes(kept)

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        """Check ``x`` against its logical axes and return it: every rank
        of the mesh shares one device, so the constraint moves nothing."""
        if len(logical) != x.ndim:
            raise ValueError(f"rank mismatch: {tuple(x.shape)} vs {logical}")
        return x

    def _spec_from_axes(self, axes) -> Spec:
        """A spec from per-dimension axes: an axis appears at most once
        (later uses dropped), axes the mesh lacks dropped, a one-axis tuple
        as its name, trailing ``None``s dropped."""
        used: set = set()
        out = []
        for ax in axes:
            if ax is None:
                out.append(None)
                continue
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat
                         if a not in used and a in self.mesh.axis_names)
            used.update(flat)
            out.append(flat if len(flat) > 1 else (flat[0] if flat else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def named_sharding(self, *logical: Optional[str]):
        """``(mesh, spec)``: the reference's ``NamedSharding`` of the
        logical axes."""
        return self.mesh, self.spec(*logical)


_STATE = threading.local()


def set_sharder(s: Optional[Sharder]) -> None:
    _STATE.sharder = s


def current_sharder() -> Optional[Sharder]:
    return getattr(_STATE, "sharder", None)


@contextlib.contextmanager
def use_sharder(s: Optional[Sharder]):
    prev = current_sharder()
    set_sharder(s)
    try:
        yield
    finally:
        set_sharder(prev)


def no_sharding():
    return use_sharder(None)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate ``x`` with logical axes; ``x`` itself when no sharder is
    installed."""
    s = current_sharder()
    if s is None:
        return x
    return s.shard(x, *logical)
