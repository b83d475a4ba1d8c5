"""Dispatch for the Medusa kernels (port of ``repro.kernels.ops``): the
three burst ops of the serving path, the KV-cache layout engine, the read
network on group tiles, the barrel rotator and the streaming matmul.

With kernels enabled (the default) each op calls its kernel wrapper
(:mod:`repro_torch.kernels.medusa_transpose`, ``rotator``,
``stream_matmul``), which launches the CUDA kernel for a CUDA tensor,
takes the plain version for a CPU tensor, and raises on anything else.
``use_kernels(False)`` routes every op to the unrolled oracles instead, on
any device — the kernels-off arm, a caller's explicit choice, never a
fallback.  The switch is this function only; no environment
variable reads it.

Kernel 4 moves a list of leaves in one launch (:func:`transpose_many`)
and is differentiable: leaves that require grad (with grad enabled) go
through :class:`_TransposeRC`, whose backward is the same movement with
the two axes exchanged — one layout-kernel launch on all the CUDA
gradients.  The kernels' outputs carry no ``grad_fn`` of their own, so
without it a training forward through the layout engine would cut its
gradient silently.  A leaf whose swap is the identity (``R == 1`` or ``C
== 1``) comes back as a view of itself, before any autograd Function: a
view is differentiable as it is.
"""

from __future__ import annotations

import torch

from repro_torch.core.transpose import (read_network_oracle,
                                        write_network_oracle)
from repro_torch.kernels import launch as kl
from repro_torch.kernels import medusa_transpose as mt
from repro_torch.kernels import ref
from repro_torch.kernels.rotator import (barrel_rotate_groups,
                                         rotate_operands)
from repro_torch.kernels.stream_matmul import stream_matmul

_USE_KERNELS = True


def use_kernels(enabled: bool) -> None:
    """Route the ops to the kernels (True) or the oracles (False)."""
    global _USE_KERNELS
    _USE_KERNELS = bool(enabled)


def kernels_enabled() -> bool:
    return _USE_KERNELS


def transpose_many(xs) -> list:
    """Swap the two leading axes of every leaf of ``xs`` (``[R, C, W] → [C,
    R, W]``, ``[B, R, C, W] → [B, C, R, W]``) through the layout-engine
    kernel, all the leaves that move in one launch
    (:func:`repro_torch.kernels.medusa_transpose.medusa_transpose_many`).
    The kernel computes the permutation for any R and C, so the
    reference's power-of-two tile padding has nothing to do here.  Kernels
    off: the plain swap of each leaf.  Every result is contiguous, so what
    consumes it sees the same strides.  With the kernels on, a leaf with
    ``R == 1`` or ``C == 1`` comes back as a view of itself with no launch:
    it aliases its input, so a caller consumes it before it writes that
    input again.  Leaves that require grad (grad enabled) go through
    :class:`_TransposeRC`; the plain swap of the kernels-off arm and the
    identity views are differentiable as they are."""
    if not _USE_KERNELS:
        return mt.medusa_transpose_many_plain(xs)
    xs = list(xs)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return mt.medusa_transpose_many(xs)
    out = [mt.identity_view(x)
           for x in mt.check_leaves(xs, "transpose_many")]
    moving = [x for x, y in zip(xs, out) if y is None]
    if moving:
        moved = iter(_TransposeRC.apply(*moving))
        out = [next(moved) if y is None else y for y in out]
    return out


def transpose_rc(x: torch.Tensor) -> torch.Tensor:
    """:func:`transpose_many` of the one leaf ``x [R, C, W]`` (→ ``[C, R,
    W]``) or ``x [B, R, C, W]`` (→ ``[B, C, R, W]``, one launch for the
    batch)."""
    return transpose_many((x,))[0]


class _TransposeRC(torch.autograd.Function):
    """Kernel 4 under autograd, on a list of leaves: the forward is one
    layout-kernel launch on all of them, the backward one launch on all
    the gradients that arrived (``[..., C, R, W] → [..., R, C, W]``),
    counted as a backward launch.  An output whose gradient is None gives
    its input a None gradient, as the plain swap does; an input that does
    not require grad gets a non-differentiable output."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.set_materialize_grads(False)
        out = mt.medusa_transpose_many(xs)
        ctx.mark_non_differentiable(*[y for y, need in zip(
            out, ctx.needs_input_grad) if not need])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        live = [g.contiguous() for g in grads if g is not None]
        with kl.backward_launches():
            moved = iter(transpose_many(live) if live else ())
        return tuple(None if g is None else next(moved) for g in grads)


def kv_line_to_port(kv):
    """KV-cache layout engine: line-major ``[T, H, D]`` (one timestep = one
    wide line across heads) → port-major ``[H, T, D]`` (one stream per
    head); ``[B, T, H, D]`` → ``[B, H, T, D]`` in one launch.  ``kv`` is a
    leaf (→ its port-major leaf) or a sequence of leaves (→ the list of
    them, one launch for all, :func:`transpose_many`)."""
    if isinstance(kv, torch.Tensor):
        return transpose_rc(kv)
    return transpose_many(kv)


def interconnect_read(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """The read network on group tiles: line stream ``[L, N, W]`` → banked
    ``[L/N, N, N, W]`` in one launch (kernel form of
    ``core.transpose.read_network_medusa``).  Kernels off: the oracle, made
    contiguous as the kernel's result is."""
    if not _USE_KERNELS:
        return mt.read_network_plain(lines, n_ports)
    return mt.read_network_tiles(lines, n_ports)


def burst_read(tile: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Packed read burst ``[N, N, W]`` → banked ``[N, N, W]`` in one
    launch."""
    if not _USE_KERNELS:
        return read_network_oracle(tile, n_ports)[0]
    return mt.burst_network_tiles(tile, n_ports)


def burst_write(banked: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Packed write burst: banked ``[N, N, W]`` → line tile ``[N, N, W]``
    (the same involution in the write direction)."""
    if not _USE_KERNELS:
        return write_network_oracle(banked[None], n_ports)
    return mt.burst_network_tiles(banked, n_ports)


def burst_gather_read(lines: torch.Tensor, idx: torch.Tensor,
                      n_ports: int) -> torch.Tensor:
    """Fused page-table gather + read network: pool lines ``[L, N, W]`` and
    frame indices ``idx [K]`` (sentinels read zero frames) → banked
    ``[K//N, N, N, W]`` of exactly the addressed frames."""
    if not _USE_KERNELS:
        return mt.gather_burst_plain(lines, idx, n_ports)
    return mt.gather_burst_network_tiles(lines, idx, n_ports)


def burst_scatter_write(banked: torch.Tensor, idx: torch.Tensor,
                        into: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Fused write network + page-table scatter: banked ``[G, N, N, W]`` →
    frames landed in place at rows ``idx [G*N]`` of ``into [L, N, W]``
    (sentinels drop; untouched rows keep their frames)."""
    if not _USE_KERNELS:
        return mt.scatter_burst_plain(banked, idx, into, n_ports)
    return mt.scatter_burst_network_tiles(banked, idx, into, n_ports)


def rotate_groups(x: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """Barrel-rotate each ``x[g] [N, W]`` left by ``amounts[g]`` (mod N)
    in one launch.  Kernels off: the reference's oracle, one roll per
    group."""
    if not _USE_KERNELS:
        amounts = rotate_operands(x, amounts)
        return torch.stack([ref.rotate_ref(xg, a)
                            for xg, a in zip(x, amounts.tolist())])
    return barrel_rotate_groups(x, amounts)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` with a float32 accumulator, cast to
    ``x.dtype`` (both bf16 or both float32): one launch of the streaming
    matmul for any M, N, K.  Kernels off: the oracle."""
    if not _USE_KERNELS:
        return ref.matmul_ref(x, w)
    return stream_matmul(x, w)
