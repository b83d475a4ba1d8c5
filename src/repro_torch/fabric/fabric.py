"""The ``Fabric``: one object for every memory movement (port of
``repro.fabric.fabric``: the ``medusa``, ``crossbar``, ``oracle`` and
``fused`` impls).

:meth:`Fabric.read`/:meth:`Fabric.write` are the paper's two data-transfer
networks (§III-A); :meth:`Fabric.read_burst`/:meth:`Fabric.write_burst` are
the burst scheduler's hot path — dense ``[N, N, W]`` bursts, or
sparse-extent transfers whose frame indices fuse the paged pool's
logical→physical gather (and scatter) into the network.  On the medusa
fabric with kernels enabled each burst is one kernel launch
(:mod:`repro_torch.kernels.ops`).  Whether a burst is kernelized depends on
the config only (impl, N, the kernel switch), never on the device, so CPU
runs report the same counters as the card.

The ``crossbar`` impl is the paper's traditional interconnect (§II),
:mod:`repro_torch.core.baseline`: every movement routes through an explicit
index tensor.  The ``fused`` impl banks no KV traffic: its consumers
contract against the line-major cache directly, so it has no layout
engine (:meth:`Fabric.kv_port_major` refuses it, as the reference never
calls it there) and its networks are the oracle's.  All impls are
value-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import FabricConfig
from repro_torch.core import baseline as _b
from repro_torch.core import transpose as _t
from repro_torch.kernels import medusa_transpose as mt
from repro_torch.kernels import ops as kops


def pm_to_banked(pm: torch.Tensor, n: int) -> torch.Tensor:
    """Port-major streams ``[N, L, D]`` → the banked ``[G, N, N, D]`` buffer
    the write network consumes (``write ∘ pm_to_banked`` is the identity on
    the corresponding ``[L, N, D]`` line stream)."""
    l, d = pm.shape[1], pm.shape[-1]
    return pm.reshape(n, l // n, n, d).permute(1, 0, 2, 3)


def _kv_crossbar(c: torch.Tensor) -> torch.Tensor:
    """``[B, T, Hkv, D] → [B, Hkv, T, D]`` through an explicit index tensor
    (the crossbar's KV layout)."""
    b, t, hkv, d = c.shape
    idx = (torch.arange(hkv, device=c.device)[:, None]
           + torch.arange(t, device=c.device)[None, :] * hkv)
    return c.reshape(b, t * hkv, d).index_select(
        1, idx.reshape(-1)).reshape(b, hkv, t, d)


@dataclasses.dataclass(frozen=True)
class Fabric:
    """A W_line ↔ N x W_acc memory-movement fabric with selectable network."""

    config: FabricConfig
    #: the mesh carrying the ``pool`` axis when ``config.pool_shards > 1``
    #: (:func:`repro_torch.fabric.sharded.make_pool_mesh`); None on the
    #: single-device fabric.
    mesh: "object | None" = dataclasses.field(default=None, compare=False)

    @classmethod
    def for_model(cls, cfg) -> "Fabric":
        return cls(cfg.resolved_fabric)

    @classmethod
    def make(cls, n_ports: int, impl: str = "medusa", **kw) -> "Fabric":
        """The fabric of ``n_ports`` ports on network ``impl`` (the other
        :class:`FabricConfig` fields from ``kw``), validated."""
        return cls(FabricConfig(n_ports=n_ports, impl=impl, **kw).validate())

    # -- geometry -------------------------------------------------------------
    @property
    def n_ports(self) -> int:
        return self.config.n_ports

    @property
    def impl(self) -> str:
        return self.config.impl

    @property
    def latency_cycles(self) -> int:
        """Constant pipeline latency of the transposition unit (§III-E)."""
        return _t.transposition_latency_cycles(self.config.n_ports)

    @property
    def banks_kv(self) -> bool:
        """Whether this fabric banks KV traffic through the networks (every
        impl except ``fused``)."""
        return self.impl != "fused"

    # -- the two data-transfer networks (paper §III-A) ------------------------
    def read(self, lines: torch.Tensor) -> torch.Tensor:
        """Read network: line stream ``[L, N, W]`` → banked
        ``[G, N(word-addr), N(port-lane), W]``."""
        n = self.config.n_ports
        if self.impl == "medusa":
            return _t.read_network_medusa(lines, n)
        if self.impl == "crossbar":
            return _b.read_network_crossbar(lines, n)
        return _t.read_network_oracle(lines, n)

    def write(self, banked: torch.Tensor) -> torch.Tensor:
        """Write network: banked port buffer → line stream."""
        n = self.config.n_ports
        if self.impl == "medusa":
            return _t.write_network_medusa(banked, n)
        if self.impl == "crossbar":
            return _b.write_network_crossbar(banked, n)
        return _t.write_network_oracle(banked, n)

    def swap_minor(self, x: torch.Tensor) -> torch.Tensor:
        """Transpose the two minor axes of ``x`` (rectangular OK) on the
        selected network: the exchange network on square tiles (medusa),
        a gather through an explicit index (crossbar), or the plain swap
        (oracle).  Each returns a contiguous tensor."""
        if self.impl == "medusa":
            return _t.medusa_swap_minor(x, tile=self.config.tile)
        r, c = x.shape[-2], x.shape[-1]
        if self.impl == "crossbar":
            lead = tuple(x.shape[:-2])
            i = torch.arange(c, device=x.device)[:, None]
            j = torch.arange(r, device=x.device)[None, :]
            idx = (j * c + i).reshape(-1)
            return x.reshape(lead + (r * c,)).index_select(-1, idx).reshape(
                lead + (c, r))
        return _t.transpose_oracle(x, x.ndim - 2, x.ndim - 1).contiguous()

    def kv_port_major(self, c):
        """KV-cache layout engine: line-major ``[B, T, Hkv, D]`` (one
        timestep = one wide line across heads) → port-major ``[B, Hkv, T,
        D]`` (one deep-narrow stream per head).  ``c`` is one leaf (→ its
        port-major leaf) or a sequence of leaves (→ the list of them).  On
        the medusa fabric this is :func:`repro_torch.kernels.ops.
        kv_line_to_port`: one layout-engine kernel launch for every leaf
        and the whole batch (the reference vmaps one kernel call over B,
        once per leaf), or the plain swap with the kernels off; a one-head
        leaf (``Hkv == 1``) comes back as a view of itself with no launch.
        The crossbar gathers each leaf through an explicit index tensor;
        the oracle impl takes each leaf's plain swap.  Each result is
        contiguous.  The ``fused`` fabric has no layout engine: its
        consumers contract the line-major cache directly, and asking it to
        bank one raises."""
        if self.impl == "fused":
            raise ValueError(
                "the fused fabric banks no KV: its consumers attend over the "
                "line-major cache (models.common.cached_attention)")
        many = not isinstance(c, torch.Tensor)
        leaves = list(c) if many else [c]
        if self.impl == "medusa":
            out = kops.kv_line_to_port(leaves)
        elif self.impl == "crossbar":
            out = [_kv_crossbar(x) for x in leaves]
        else:
            out = mt.medusa_transpose_many_plain(leaves)
        return out if many else out[0]

    # -- first-class bursts (the scheduler's hot path) -------------------------
    @property
    def burst_kernelized(self) -> bool:
        """Whether bursts lower through the fused kernels: medusa impl,
        kernels enabled, power-of-two N.  Independent of the device."""
        n = self.config.n_ports
        return (self.impl == "medusa" and kops.kernels_enabled()
                and n >= 2 and n & (n - 1) == 0)

    def burst_kernelized_for(self, dtype: torch.dtype) -> bool:
        """:attr:`burst_kernelized`, per payload dtype (complex payloads
        stay on the unrolled path, as in the reference)."""
        return self.burst_kernelized and not dtype.is_complex

    def read_burst(self, burst: torch.Tensor,
                   indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One packed ``[N, N, W]`` read burst → banked ``[N, N, W]``.

        With ``indices`` the burst is sparse-extent: ``burst`` is a pool
        line stream ``[L, N, W]`` and ``indices [K]`` (K a multiple of N;
        entries ``>= L`` are sentinels reading as zero frames) names the
        live frames — the network banks only those, ``[K//N, N, N, W]``."""
        n = self.config.n_ports
        if indices is not None:
            if burst.ndim != 3 or burst.shape[1] != n:
                raise ValueError(f"sparse read wants pool lines [L, N, W] "
                                 f"for N={n}, got {tuple(burst.shape)}")
            if indices.shape[0] % n:
                raise ValueError(f"gather index count {indices.shape[0]} "
                                 f"must be a multiple of N={n}")
            if self.burst_kernelized_for(burst.dtype):
                return kops.burst_gather_read(burst, indices, n)
            return self.read(_take_fill(burst, indices))
        self._check_burst(burst)
        if self.burst_kernelized_for(burst.dtype):
            return kops.burst_read(burst, n)
        return self.read(burst)[0]

    def write_burst(self, banked: torch.Tensor,
                    indices: Optional[torch.Tensor] = None,
                    into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write direction of :meth:`read_burst`: one banked ``[N, N, W]``
        tile → the ``[N, N, W]`` line tile headed back to memory.

        With ``indices`` and ``into`` (the pool line stream ``[L, N, W]``)
        this is the sparse-extent scatter: the write network reassembles
        the banked ``[G, N, N, W]`` live frames and each lands at its
        indexed row of ``into`` **in place** (sentinels drop, untouched
        rows keep their bytes).  ``into`` is usually a view of a pool
        leaf, so the leaf itself is updated; this saves the pool-sized copy
        a functional scatter would make per step.  Returns ``into``."""
        n = self.config.n_ports
        if indices is not None:
            if into is None:
                raise ValueError("sparse write_burst needs the pool stream "
                                 "to scatter into (into=)")
            if banked.ndim != 4 or banked.shape[1] != n \
                    or banked.shape[2] != n:
                raise ValueError(f"sparse write wants banked [G, N, N, W] "
                                 f"for N={n}, got {tuple(banked.shape)}")
            if indices.shape[0] != banked.shape[0] * n:
                raise ValueError(f"scatter index count {indices.shape[0]} != "
                                 f"banked line count {banked.shape[0] * n}")
            if self.burst_kernelized_for(banked.dtype):
                return kops.burst_scatter_write(banked, indices, into, n)
            _put_drop(into, indices, self.write(banked))
            return into
        self._check_burst(banked)
        if self.burst_kernelized_for(banked.dtype):
            return kops.burst_write(banked, n)
        return self.write(banked[None])

    # -- the sharded pool -------------------------------------------------------
    @property
    def pool_sharded(self) -> bool:
        """Whether sparse bursts lower as the two-hop collective over the
        ``pool`` mesh axis (``config.pool_shards > 1`` and a mesh bound)."""
        return self.config.pool_shards > 1 and self.mesh is not None

    def read_burst_sharded(self, stream: torch.Tensor, fetch: torch.Tensor,
                           place: torch.Tensor, k_tot: int) -> torch.Tensor:
        """Sparse read burst over the pool-sharded line stream ``[R, F, N,
        W]``: each shard fuse-gathers its owned frames (:meth:`read_burst`
        at the plan's ``fetch`` rows, kernel 1 on the card), one collective
        delivers them, and the result is the banked ``[k_tot//N, N, N, W]``
        the single-device sparse read produces, bit for bit.  The ``fetch``
        / ``place`` operands come from
        :func:`repro_torch.fabric.sharded.shard_plan`."""
        from repro_torch.fabric import sharded as _sh
        return _sh.sharded_read_burst(self, stream, fetch, place, k_tot)

    def write_burst_sharded(self, banked: torch.Tensor, fetch: torch.Tensor,
                            place: torch.Tensor,
                            into: torch.Tensor) -> torch.Tensor:
        """Write direction of :meth:`read_burst_sharded`: the same plan run
        in reverse lands each banked live frame at its owning shard's pool
        row of ``into [R, F, N, W]``, in place (the local fused scatter,
        kernel 2 on the card, after the collective hop).  Returns
        ``into``."""
        from repro_torch.fabric import sharded as _sh
        return _sh.sharded_write_burst(self, banked, fetch, place, into)

    def _check_burst(self, tile: torch.Tensor) -> None:
        n = self.config.n_ports
        if tile.ndim != 3 or tile.shape[0] != n or tile.shape[1] != n:
            raise ValueError(f"burst tile must be [N, N, W] for N={n}, "
                             f"got {tuple(tile.shape)}")

    # -- data-dependent routing ------------------------------------------------
    def route(self, data: torch.Tensor, index: torch.Tensor,
              axis: int = 0) -> torch.Tensor:
        """Gather ``data`` along ``axis`` through an explicit ``index`` (any
        shape, entries in ``[0, size)``): the crossbar primitive for
        data-dependent destinations, identical across impls."""
        axis %= data.ndim
        return data.index_select(axis, index.reshape(-1)).reshape(
            tuple(data.shape[:axis]) + tuple(index.shape)
            + tuple(data.shape[axis + 1:]))


def _take_fill(x: torch.Tensor, idx: torch.Tensor,
               axis: int = 0) -> torch.Tensor:
    """``take(x, idx, axis, mode="fill", fill_value=0)``: rows at indices
    outside ``[0, size)`` read as zeros.  ``idx`` may have any shape; it
    replaces ``axis`` in the result."""
    size = x.shape[axis]
    flat = idx.reshape(-1)
    valid = (flat >= 0) & (flat < size)
    out = x.index_select(axis, torch.where(valid, flat, 0).long())
    shape = [1] * out.ndim
    shape[axis] = flat.shape[0]
    out = torch.where(valid.view(shape), out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def _put_drop(x: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
              axis: int = 0) -> None:
    """In-place ``x.at[idx].set(upd, mode="drop")`` along ``axis``: rows at
    indices outside ``[0, size)`` drop.  Live indices are unique (the pool
    never maps a frame twice), so the scatter is exact."""
    flat = idx.reshape(-1)
    valid = (flat >= 0) & (flat < x.shape[axis])
    keep = valid.nonzero().reshape(-1)
    x.index_copy_(axis, flat[keep].long(), upd.index_select(axis, keep))
