"""Step builders (port of ``repro.launch.steps``): the train, prefill and
decode steps over a mesh, with the reference's sharding specs.

This is where logical axes meet the mesh: parameter leaves get specs by
name (stacked-layer and expert dims handled), optimizer state gets ZeRO-1
data-axis specs, caches get batch/heads/seq specs per profile, and the
batch splits over the data axes.  A spec is a tuple (see
:mod:`repro_torch.parallel.sharding`); a spec tree is a dict keyed by the
reference's leaf paths (``convert.reference_leaves``; ``convert.keystr``
gives ``jax.tree_util.keystr``'s string), so it equals the reference's
``PartitionSpec`` pytree leaf by leaf.  The specs are computed from
shapes alone (the ``meta`` device), so a full-width config costs no
memory.

Every rank of the mesh lives on the run's one device, so the reference's
pjit partitioning becomes explicit work in one process: the train step
splits its batch into the rank blocks the batch's spec gives, takes each
block's gradient in turn and averages them as :func:`repro_torch.
parallel.collectives.dp_grad_mean` does, in a running sum; ZeRO-1 changes the optimizer-state
specs only (the state stays whole on the device); the serving steps run
as on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import (FabricConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.convert import param_list, reference_leaves
from repro_torch.data.pipeline import TensorSpec, make_batch_specs
from repro_torch.fabric import BurstScheduler, Fabric
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.optim import OptState, adamw_update
from repro_torch.parallel.sharding import Sharder, axis_sizes, rules_for

# ---------------------------------------------------------------------------
# parameter logical axes by leaf name
# ---------------------------------------------------------------------------

# name → logical axes for the *unstacked* leaf.  "attn_io" is the TP axis of
# attention projections, "moe_ff" the per-expert FFN axis (moe_cap profile).
PARAM_AXES_2D = {
    "table": ("vocab", "d_model"),
    "head": ("d_model", "vocab"),
    "wq": ("d_model", "attn_io"), "wk": ("d_model", "attn_io"),
    "wv": ("d_model", "attn_io"), "wo": ("attn_io", "d_model"),
    "w_gate": ("d_model", "d_ff"), "w_up": ("d_model", "d_ff"),
    "w_out": ("d_ff", "d_model"),
    "w_xz": ("d_model", "inner"), "w_bc": ("d_model", None),
    "w_dt": ("d_model", None),
    "w_branch": ("d_model", "inner"), "w_a": ("inner", "inner_out"),
    "w_i": ("inner", "inner_out"), "router": ("d_model", None),
    "conv_w": (None, "inner"),
}
PARAM_AXES_MOE_3D = {                    # [experts, in, out]
    "w_gate": ("experts", "d_model", "moe_ff"),
    "w_up": ("experts", "d_model", "moe_ff"),
    "w_out": ("experts", "moe_ff", "d_model"),
}
PARAM_AXES_1D = {
    "conv_b": ("inner",), "gate_norm": ("inner",), "lam": ("inner",),
    "b_a": ("inner",), "b_i": ("inner",),
}

# extra rules appended to every profile
EXTRA_RULES = {"attn_io": "model", "inner_out": None, "moe_ff": None}
EXTRA_RULES_MOE_CAP = {"attn_io": "model", "inner_out": None,
                       "moe_ff": "model"}


def resolve_fabric(cfg: ModelConfig, shape: ShapeConfig) -> FabricConfig:
    """Validate the model's fabric against a serving shape at build time.

    The decode cache is a ``[B, T, Hkv, D]`` line stream whose line width
    must be the fabric's W_line (one timestep across the port heads); for
    decode shapes the paged pool's page must fit the cache depth.  Pure
    validator: page clamping happens where pages are allocated."""
    fab = cfg.resolved_fabric
    has_attn = any(t in ("A", "L") for t in cfg.layer_types())
    if cfg.fabric is not None and has_attn and cfg.n_kv_heads:
        want = cfg.n_kv_heads * cfg.resolved_head_dim
        if fab.line_width != want:
            raise ValueError(
                f"{cfg.name}: fabric W_line={fab.line_width} does not match "
                f"the KV line (n_kv_heads*head_dim={want})")
        if (fab.paged_pool and shape.kind == "decode"
                and fab.page_size > shape.seq_len):
            raise ValueError(
                f"{cfg.name}: fabric page_size={fab.page_size} exceeds the "
                f"decode cache depth ({shape.name}: seq_len={shape.seq_len})")
    return fab


def make_sharder(cfg: ModelConfig, mesh) -> Sharder:
    rules = rules_for(cfg.sharding_profile)
    rules.update(EXTRA_RULES_MOE_CAP if cfg.sharding_profile == "moe_cap"
                 else EXTRA_RULES)
    return Sharder(mesh, rules)


def _leaf_logical_axes(path, shape, cfg: ModelConfig) -> tuple:
    """The logical axes of a parameter leaf of ``shape`` at the reference
    path ``path`` (its dict keys; list indices are skipped, as the
    reference's key names skip them)."""
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else None
    stacked = 1 if (names and names[0] in ("unit", "encoder", "decoder")) else 0
    core = len(shape) - stacked
    is_moe = "ffn" in names and cfg.moe is not None and core == 3
    if is_moe and name in PARAM_AXES_MOE_3D:
        axes = PARAM_AXES_MOE_3D[name]
    elif core == 2 and name in PARAM_AXES_2D:
        axes = PARAM_AXES_2D[name]
    elif core == 1 and name in PARAM_AXES_1D:
        axes = PARAM_AXES_1D[name]
    else:
        axes = (None,) * core
    return (None,) * stacked + tuple(axes)


def leaf_shapes(params) -> dict:
    """``{reference path: shape}`` of every parameter leaf, in the
    reference's leaf order; a stacked ``unit`` leaf with its leading
    repetition axis."""
    return {path: ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            for path, ts, stacked in reference_leaves(params)}


def param_specs(params, cfg: ModelConfig, sharder: Sharder) -> dict:
    """``{reference path: spec}`` of a parameter tree (respects
    divisibility)."""
    return {path: sharder.safe_spec(shape,
                                    _leaf_logical_axes(path, shape, cfg))
            for path, shape in leaf_shapes(params).items()}


def zero1_specs(pspecs: dict, params, sharder: Sharder) -> dict:
    """ZeRO-1: each optimizer-state leaf additionally over the data axes,
    on its first dimension that is free and divisible."""
    data_axes = tuple(a for a in ("pod", "data")
                      if a in sharder.mesh.axis_names)
    sizes = axis_sizes(sharder.mesh)
    dp = math.prod(sizes[a] for a in data_axes)

    def one(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % dp == 0 and dim > 0 and dp > 1:
                entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                return sharder._spec_from_axes(entries)
        return spec
    shapes = leaf_shapes(params)
    return {path: one(spec, shapes[path]) for path, spec in pspecs.items()}


def _tree_leaves(tree, path=()):
    """``(path, tensor)`` of a nested dict/list tree, dict keys sorted (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tree_leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _tree_leaves(sub, path + (i,))
    else:
        yield path, tree


def cache_specs(caches, cfg: ModelConfig, sharder: Sharder) -> dict:
    """``{path: spec}`` of a decode-cache tree, by leaf name."""
    def one(path, leaf):
        names = [k for k in path if isinstance(k, str)]
        name = names[-1] if names else None
        nd = leaf.ndim
        if name in ("k", "v"):
            logical = (None, "batch", "kv_seq", "kv_heads", None)[5 - nd:]
        elif name in ("cross_k", "cross_v"):
            logical = (None, "batch", "kv_heads", "frames", None)[5 - nd:]
        elif name == "state":
            logical = (None, "batch", "inner", None, None)[5 - nd:]
        elif name == "conv":
            logical = (None, "batch", None, "inner")[4 - nd:]
        elif name == "h":
            logical = (None, "batch", "inner")[3 - nd:]
        else:
            logical = (None,) * nd
        return sharder.safe_spec(tuple(leaf.shape), logical)
    return {path: one(path, leaf) for path, leaf in _tree_leaves(caches)}


def batch_specs_sharding(batch_specs: dict, sharder: Sharder) -> dict:
    """``{name: spec}`` of a step's inputs: the first axis over the batch
    axes."""
    return {name: sharder.safe_spec(
                spec.shape, ("batch",) + (None,) * (len(spec.shape) - 1))
            for name, spec in batch_specs.items()}


def batch_blocks(bshard: dict, mesh) -> int:
    """How many rank blocks the batch splits into: the product of the
    sizes of the axes on its first dimension."""
    sizes = axis_sizes(mesh)
    firsts = {spec[0] if spec else None for spec in bshard.values()}
    if len(firsts) != 1:
        raise ValueError(f"the batch's leaves split differently: {bshard}")
    first = firsts.pop()
    if first is None:
        return 1
    return math.prod(sizes[a] for a in ((first,) if isinstance(first, str)
                                        else first))


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltStep:
    fn: Callable                  # the step: (state, batch) -> (state, metrics)
    input_specs: dict             # the inputs' TensorSpecs
    grad_accum: int = 1           # microbatches per rank block
    param_specs: Optional[dict] = None
    opt_specs: Optional[OptState] = None
    batch_specs: Optional[dict] = None
    cache_specs: Optional[dict] = None
    batch_blocks: int = 1         # rank blocks the batch splits into


def _eval_params(cfg: ModelConfig):
    """The parameters' shapes, nothing allocated (the ``meta`` device)."""
    return api.init_params(cfg, device="meta")


def _single_mesh():
    """The 1x1 (data, model) mesh, axis sizes alone."""
    return make_mesh((1, 1), ("data", "model"), device="meta")


def _auto_grad_accum(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1,
                     tp: int = 1, budget_bytes: float = 4e9) -> int:
    """Microbatch count so the activation residuals fit the budget (the
    reference's estimate: the layer carries ``B_loc x S x d_model`` bf16
    per layer plus float32 logits and their gradient over the local vocab
    shard; ``dp`` and ``tp`` are the data (pod x data) and model axis
    sizes)."""
    b_loc = max(shape.global_batch // dp, 1)
    tokens = b_loc * shape.seq_len
    resid = tokens * cfg.d_model * 2 * cfg.n_layers
    vshard = -(-cfg.vocab_size // tp)
    logits = tokens * vshard * 4 * 2          # logits + grad copy
    need = resid + logits
    accum = 1
    while need / accum > budget_bytes and accum < shape.global_batch // dp:
        accum *= 2
    return accum


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _check_device(mesh, device) -> None:
    dev = mesh.devices[0]
    if dev.type != "meta" and dev != device:
        raise ValueError(f"the mesh lies on {dev}, the parameters on "
                         f"{device}")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     tcfg: Optional[TrainConfig] = None, *,
                     mesh=None) -> BuiltStep:
    """The full training step over ``mesh`` (default: 1x1): the
    (accumulated) loss, its gradients and one AdamW update, ``fn(state,
    batch) -> (state, metrics)`` with ``state = {"params", "opt"}`` (an
    ``OptState``) and ``metrics = {"loss", "grad_norm", "lr"}`` (float32
    scalars on the device).

    The batch splits along its first axis into the rank blocks its spec
    gives (batch 8 on (pod=2, data=16, model=16) keeps the ``pod`` prefix:
    2 blocks of 4).  Each block takes its gradient in turn: with
    ``grad_accum > 1`` (0 picks it by :func:`_auto_grad_accum` from the
    mesh's data and model sizes) the block splits into that many
    microbatches, their float32 gradients summed and divided by the count.
    The blocks' gradients are averaged as :func:`repro_torch.parallel.
    collectives.dp_grad_mean` (``"none"``) averages them, bit for bit: a float32 running sum from zero in rank
    order, added to as each block finishes, then divided by the block
    count, so one block's gradient is held beside the sum whatever the
    block count.  AdamW then updates the parameters and the optimizer
    state in place.  The loss is the mean of every microbatch's.

    The mean equals the reference's pjit step only where the blocks times
    their microbatches make the reference's microbatches (its ``accum``
    over the whole batch).  Otherwise a loss that is not a mean of
    independent tokens differs: the MoE routes each microbatch's tokens
    with its own capacity and load-balance loss, so granite over a mesh
    computes other numbers than one rank at the same flags (ROADMAP §3,
    item 8b (4)).  The step sets ``requires_grad`` on the parameters (the
    serving paths never do).  ``opt_specs`` is the spec tree of the state
    the callers build (``init_opt_state(master=False)``); ``tcfg.zero1``
    changes it only: the state stays whole on the device, so no number
    changes."""
    tcfg = tcfg or TrainConfig()
    mesh = mesh or _single_mesh()
    sharder = make_sharder(cfg, mesh)
    sizes = axis_sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    accum = tcfg.grad_accum or _auto_grad_accum(cfg, shape, dp,
                                                sizes.get("model", 1))
    bspecs = make_batch_specs(cfg, shape.global_batch, shape.seq_len,
                              kind="train")
    bshard = batch_specs_sharding(bspecs, sharder)
    n_blocks = batch_blocks(bshard, mesh)

    def loss_and_grads(params, ps, mbatch):
        loss = api.loss_fn(params, mbatch, cfg)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def block_grads(params, ps, batch):
        """One rank block's microbatch losses and float32 gradient."""
        if accum == 1:
            loss, grads = loss_and_grads(params, ps, batch)
            return [loss], [g.float() for g in grads]
        micro = {k: v.reshape((accum, v.shape[0] // accum)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in ps]
        losses = []
        for i in range(accum):
            loss_i, g_i = loss_and_grads(
                params, ps, {k: v[i] for k, v in micro.items()})
            for a, b in zip(grads, g_i):
                a.add_(b.float())
            del g_i
            losses.append(loss_i)
        for g in grads:
            g.div_(accum)
        return losses, grads

    def train_step(state, batch):
        params = state["params"]
        ps = param_list(params)
        _check_device(mesh, ps[0].device)
        for p in ps:
            p.requires_grad_(True)
        batch = _on_device(batch, ps[0].device)
        blocks = [dict(zip(batch, parts)) for parts in
                  zip(*(v.chunk(n_blocks) for v in batch.values()))]
        losses, grads = [], None
        for block in blocks:
            block_losses, g = block_grads(params, ps, block)
            losses += block_losses
            if n_blocks == 1:
                grads = g
                continue
            if grads is None:
                grads = [torch.zeros_like(x) for x in g]
            for total, x in zip(grads, g):
                total.add_(x)
            del g
        if n_blocks > 1:
            for total in grads:
                total.div_(n_blocks)
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).mean()
        params, opt, metrics = adamw_update(grads, state["opt"], params,
                                            tcfg)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    params_shapes = _eval_params(cfg)
    pspecs = param_specs(params_shapes, cfg, sharder)
    mspecs = (zero1_specs(pspecs, params_shapes, sharder) if tcfg.zero1
              else pspecs)
    opt_specs = OptState(step=(), m=mspecs, v=mspecs, master=None)
    return BuiltStep(train_step, bspecs, accum, param_specs=pspecs,
                     opt_specs=opt_specs, batch_specs=bshard,
                     batch_blocks=n_blocks)


def _serve_specs(cfg: ModelConfig, shape: ShapeConfig, sharder: Sharder):
    """The serving steps' parameter specs (ZeRO-1 over the data axes under
    ``serve_fsdp``) and cache specs."""
    params_shapes = _eval_params(cfg)
    pspecs = param_specs(params_shapes, cfg, sharder)
    if cfg.serve_fsdp:   # inference FSDP: stream weights over the data axis
        pspecs = zero1_specs(pspecs, params_shapes, sharder)
    caches = api.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device="meta")
    return pspecs, cache_specs(caches, cfg, sharder)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh) -> BuiltStep:
    """Prefill ``fn(params, batch) -> (logits [B, 1, V], caches)`` with
    caches of depth ``shape.seq_len``."""
    resolve_fabric(cfg, shape)
    sharder = make_sharder(cfg, mesh)
    t_max = shape.seq_len

    def prefill_step(params, batch):
        dev = param_list(params)[0].device
        _check_device(mesh, dev)
        return api.prefill_fn(params, _on_device(batch, dev), cfg, t_max)

    pspecs, cspecs = _serve_specs(cfg, shape, sharder)
    bspecs = make_batch_specs(cfg, shape.global_batch, shape.seq_len,
                              kind="prefill")
    return BuiltStep(prefill_step, bspecs, param_specs=pspecs,
                     batch_specs=batch_specs_sharding(bspecs, sharder),
                     cache_specs=cspecs)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      mesh) -> BuiltStep:
    """One decode step ``fn(params, caches, token, pos) -> (logits [B, 1,
    V], caches)`` against a ``seq_len``-deep cache, read through the
    model's fabric (:func:`resolve_fabric` checks the geometry first).
    Under ``cfg.serve_fsdp`` the step runs burst-scheduled: the weights
    ride the same read burst as the KV banking."""
    fab = resolve_fabric(cfg, shape)
    sharder = make_sharder(cfg, mesh)

    def serve_step(params, caches, token, pos):
        dev = param_list(params)[0].device
        _check_device(mesh, dev)
        sched = BurstScheduler(Fabric(fab)) if cfg.serve_fsdp else None
        return api.decode_fn(params, torch.as_tensor(token, device=dev),
                             caches, pos, cfg, sched=sched)

    pspecs, cspecs = _serve_specs(cfg, shape, sharder)
    inputs = {"token": TensorSpec((shape.global_batch, 1), torch.int32),
              "pos": TensorSpec((), torch.int32)}
    return BuiltStep(serve_step, inputs, param_specs=pspecs,
                     batch_specs=batch_specs_sharding(
                         {"token": inputs["token"]}, sharder),
                     cache_specs=cspecs)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tcfg: Optional[TrainConfig] = None) -> BuiltStep:
    """Dispatch on the shape kind (train / prefill / decode)."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, tcfg, mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)
