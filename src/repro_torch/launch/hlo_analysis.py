"""The cost census of a step for the roofline analysis (port of
``repro.launch.hlo_analysis``).

Eager PyTorch has no HLO.  The module keeps the reference's name, so a
reader finds the counterpart, and reads the aten ops a step dispatches
instead: :func:`analyze_step` runs the step under a ``TorchDispatchMode``
(the mechanism ``torch.utils.flop_counter`` uses) and charges each op by
the reference's model:

* FLOPs: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``addbmm``, ``mv``, ``addmv``, ``dot``) contributes ``2 x prod(result) x
  prod(contracted)``, as the reference counts ``dot`` only (a convolution
  counts nothing in either).
* HBM bytes: a computing op moves its operands in and its results out (an
  in-place one its operands in and the tensors it writes out).  A view, a
  metadata op or an allocation moves nothing.  A copying slice or gather
  (``index_select``, ``gather``, advanced indexing, ``embedding``) moves
  2x its result, as the reference charges ``gather`` and
  ``dynamic-slice``; an in-place update (``index_copy_``, ``index_put_``,
  ``scatter_``, ``index_add_``) 2x its update and ``copy_`` its source and
  its target region, as the reference charges ``dynamic-update-slice``; a
  fill writes its region once.  An operand counts the elements its strides
  reach: a broadcast dimension once.  A transfer between the host and a
  device (a copy across them, ``.item()``) moves no HBM bytes of the model:
  it crosses the host link, and the reference's step has none.
* collective bytes: the port's collectives (:mod:`repro_torch.parallel.
  collectives`) are Python over every rank's tensors, not aten ops.  Each
  reports itself (:func:`repro_torch.kernels.launch.report_collective`)
  under the reference's HLO name, its payload ``max(operand bytes, result
  bytes)`` over the ranks; the aten copies it makes on the one device are
  charged as bytes like any other op.
* the hand-written kernels launch through ``ctypes``, which no dispatch
  mode sees: each wrapper reports its launch beside its launch count,
  priced by :func:`repro_torch.kernels.launch.kernel_cost`, and it counts
  as an op of the kernel's name.

A loop body is dispatched once per trip, so no trip count needs
recovering: :attr:`HloCosts.op_counts` (op → calls) takes the place of the
reference's ``while_trip_counts``.  Every rank of a mesh runs in turn on
the one device, so the costs are the whole step's, not one device's share.

On ``meta`` tensors (shapes alone, nothing allocated) three ops read
values that meta has not got, and the census answers them:
``aten._local_scalar_dense`` (``.item()``: 0, 0.0 or False),
``aten.nonzero`` (every element a row: the upper bound, as the
reference's static-shape scatter moves every row) and a copy to the CPU
(zeros).  Each answer counts in :attr:`HloCosts.stand_ins`, and the op is
charged as it would be, on its stand-in result.  On ``cpu`` or ``cuda``
the census answers nothing.

The census also keeps the running sum of the storage bytes live in the
step, each storage once: the arguments' storages throughout, and each
storage an op creates until its last tensor dies.  Its peak is
:attr:`HloCosts.peak_bytes`.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import launch as kl
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

aten = torch.ops.aten

# the reference's HLO names of the dtypes, for the ops' lines
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

def _mm_contracted(args) -> int:
    return args[0].shape[-1]


def _add_mm_contracted(args) -> int:
    return args[1].shape[-1]


# the matmul family: op → the product of its contracted dimensions
_MATMUL = {
    aten.mm: _mm_contracted, aten.bmm: _mm_contracted,
    aten.mv: _mm_contracted, aten.dot: _mm_contracted,
    aten.addmm: _add_mm_contracted, aten.baddbmm: _add_mm_contracted,
    aten.addmv: _add_mm_contracted,
    aten.addbmm: lambda args: args[1].shape[0] * args[1].shape[-1],
}
# views' kin that alias without saying so, and allocations that take a
# tensor only for its shape, dtype and device
_FREE = {aten._unsafe_view, aten.empty_like, aten.zeros_like,
         aten.ones_like, aten.full_like, aten.rand_like, aten.randn_like,
         aten.new_empty, aten.new_empty_strided, aten.new_zeros,
         aten.new_ones, aten.new_full, aten.resize_, aten.set_}
# copying slices and gathers: 2x the result
_GATHERS = {aten.index_select, aten.gather, aten.index, aten._unsafe_index,
            aten.embedding, aten.take, aten.masked_select, aten.narrow_copy,
            aten.slice_copy, aten.select_copy}
# in-place updates: the argument holding the update
_UPDATES = {aten.index_copy_: 3, aten.index_put_: 2,
            aten._index_put_impl_: 2, aten.scatter_: 3,
            aten.scatter_add_: 3, aten.scatter_reduce_: 3,
            aten.index_add_: 3}
_FILLS = {aten.fill_, aten.zero_}


def _reached(t: torch.Tensor) -> int:
    """Bytes of the elements ``t``'s strides reach (a broadcast dimension,
    stride 0, once)."""
    if t.numel() == 0:
        return 0
    return math.prod(s for s, st in zip(t.shape, t.stride())
                     if st != 0) * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _describe(t: torch.Tensor) -> str:
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(map(str, t.shape))}]"


def _line(op: str, tensors) -> str:
    """The op with its operands' dtypes and shapes (the first four)."""
    shown = ", ".join(_describe(t) for t in tensors[:4])
    more = f", +{len(tensors) - 4} more" if len(tensors) > 4 else ""
    return f"{op}({shown}{more})"


_COPIES = {aten._to_copy, aten.copy_, aten._copy_from}


def _crosses_host(packet, operands, results) -> bool:
    """Whether the op is a copy between the CPU and another device."""
    devices = {t.device.type for t in operands + results}
    return packet in _COPIES and "cpu" in devices and len(devices) > 1


def _op_cost(func, args, operands, out) -> tuple:
    """``(bytes, flops)`` of one dispatched aten op ``func`` on ``args``
    (its tensors, keywords' too, ``operands``) with result ``out`` (the
    module's model)."""
    packet = func.overloadpacket
    results = _tensors(out)
    flops = 0
    if packet in _MATMUL:
        flops = 2 * results[0].numel() * _MATMUL[packet](args)
    if (func.is_view or packet in _FREE or not operands
            or packet is aten._local_scalar_dense
            or _crosses_host(packet, operands, results)):
        return 0, flops
    if packet in _GATHERS:
        return 2 * sum(_reached(t) for t in results), flops
    if packet in _UPDATES:
        if packet is aten.scatter_ and not isinstance(args[3], torch.Tensor):
            update = args[2].numel() * args[0].element_size()
        else:
            update = _reached(args[_UPDATES[packet]])
        return 2 * update, flops
    if packet is aten.copy_:
        return _reached(args[1]) + _reached(args[0]), flops
    if packet in _FILLS:
        return _reached(args[0]), flops
    if not results:             # an in-place op returning nothing
        schema = func._schema.arguments
        results = _tensors([a for a, s in zip(args, schema)
                            if s.alias_info is not None
                            and s.alias_info.is_write])
    return (sum(_reached(t) for t in operands)
            + sum(_reached(t) for t in results), flops)


@dataclasses.dataclass
class HloCosts:
    """A step's costs: FLOPs, HBM bytes and collective bytes (the
    reference's fields), the collectives by kind (``[count, bytes]``), the
    calls of each op, the stand-ins answered on meta, the peak of live
    storage bytes, and every op line's ``[op, bytes, flops, collective
    bytes, calls]`` (what :func:`repro_torch.launch.profile.breakdown`
    ranks).  The sums are exact integers."""
    flops: float = 0
    bytes: float = 0
    collective_bytes: float = 0
    collective_census: Dict[str, list] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0]))
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    stand_ins: int = 0
    peak_bytes: int = 0
    lines: Dict[str, list] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": {k: {"count": v[0], "bytes": v[1]}
                            for k, v in self.collective_census.items()},
            "op_counts": dict(self.op_counts),
            "stand_ins": self.stand_ins,
            "peak_bytes": self.peak_bytes,
        }

    def add(self, op: str, line: str, nbytes: int = 0, flops: int = 0,
            collective: int = 0) -> None:
        """Charge one call of ``op`` (its line ``line``)."""
        self.bytes += nbytes
        self.flops += flops
        self.collective_bytes += collective
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        rec = self.lines.setdefault(line, [op, 0, 0, 0, 0])
        rec[1] += nbytes
        rec[2] += flops
        rec[3] += collective
        rec[4] += 1


class _Census(TorchDispatchMode):
    """Charges every dispatched op to ``costs``, answers meta's value
    reads, keeps the live storage bytes, and listens to the kernels' and
    collectives' reports (:func:`repro_torch.kernels.launch.listening`)."""

    def __init__(self, costs: HloCosts):
        super().__init__()
        self.costs = costs
        self._live: Dict[int, list] = {}      # storage → [bytes, tensors]
        self._live_bytes = 0

    # -- live storage ------------------------------------------------------
    def pin(self, tensors) -> None:
        """Count the storages of ``tensors`` (the step's arguments) live
        throughout."""
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self._live:
                self._live[st._cdata] = [st.nbytes(), 1]
                self._live_bytes += st.nbytes()
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        rec = self._live.get(st._cdata)
        if rec is None:
            self._live[st._cdata] = [st.nbytes(), 1]
            self._live_bytes += st.nbytes()
            self.costs.peak_bytes = max(self.costs.peak_bytes,
                                        self._live_bytes)
        else:
            rec[1] += 1
        weakref.finalize(t, self._release, st._cdata).atexit = False

    def _release(self, key: int) -> None:
        rec = self._live.get(key)
        if rec is None:                   # a storage swapped by ``set_``
            return
        rec[1] -= 1
        if rec[1] == 0:
            self._live_bytes -= rec[0]
            del self._live[key]

    # -- meta's value reads ----------------------------------------------
    def _stand_in(self, func, args, kwargs):
        """The answer to a value read on meta, or None."""
        if func is aten._local_scalar_dense.default:
            dtype = args[0].dtype
            return (False if dtype == torch.bool
                    else 0.0 if dtype.is_floating_point else 0)
        if func is aten.nonzero.default:
            x = args[0]
            return torch.empty((x.numel(), x.ndim), dtype=torch.long,
                               device="meta")
        if (func is aten._to_copy.default
                and torch.device(kwargs.get("device") or "meta").type
                == "cpu"):
            return torch.zeros(args[0].shape, dtype=kwargs.get("dtype")
                               or args[0].dtype)
        if func is aten.copy_.default and args[0].device.type == "cpu":
            return args[0].zero_()
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        operands = _tensors((args, kwargs))
        out = None
        if any(t.is_meta for t in operands):
            out = self._stand_in(func, args, kwargs)
            if out is not None:
                self.costs.stand_ins += 1
        if out is None:
            out = func(*args, **kwargs)
        nbytes, flops = _op_cost(func, args, operands, out)
        self.costs.add(str(func), _line(str(func.overloadpacket).replace(
            "aten.", ""), operands), nbytes, flops)
        for t in _tensors(out):
            self._hold(t)
        return out

    # -- the reports of kernels and collectives -------------------------
    def kernel(self, name: str, operands: dict) -> None:
        with _disable_current_modes():
            nbytes, flops = kl.kernel_cost(name, **operands)
        self.costs.add(name, _line(name, _tensors(operands)), nbytes, flops)

    def collective(self, kind: str, operands, results) -> None:
        payload = max(sum(kl.nbytes(t) for t in operands),
                      sum(kl.nbytes(t) for t in results))
        census = self.costs.collective_census[kind]
        census[0] += 1
        census[1] += payload
        self.costs.add(kind, _line(kind, list(operands)), collective=payload)


def analyze_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the census; returns ``(result,
    HloCosts)``.  The arguments' storages count as live throughout."""
    costs = HloCosts()
    census = _Census(costs)
    census.pin(_held((args, kwargs)))
    with kl.listening(census), census:
        result = fn(*args, **kwargs)
    return result, costs


def _held(tree) -> list:
    """Every tensor ``tree`` holds: through dicts, lists, tuples, the
    fields of dataclasses (an ``OptState``) and a module's parameters and
    buffers (an ``LM``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for sub in tree for t in _held(sub)]


# ---------------------------------------------------------------------------
# analytic model FLOPs (the "useful work" reference of the roofline)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """6·N·D for training (N = active params, D = tokens); 2·N·D for
    forward-only (prefill); 2·N·B per decode step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch    # one decode step


def roofline_terms(costs: HloCosts, chips: int,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict:
    """Three roofline terms in seconds, at the H100's data-sheet rates by
    default (:mod:`repro_torch.launch.mesh`).  ``chips`` is the
    reference's argument and, as there, unused: the costs are those of the
    device that runs them (here the whole step, every rank on one card)."""
    compute_s = costs.flops / peak_flops
    memory_s = costs.bytes / hbm_bw
    collective_s = costs.collective_bytes / link_bw
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
