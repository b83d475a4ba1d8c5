"""Carry parameters and training state across the two packages:
``params_from_jax`` one way, :func:`reference_leaves` /
:func:`to_reference_tree` the other.

The input is the reference's parameter tree with every leaf already a
numpy array (``{"embed": {"table"}, "unit": [stacked block dicts], "tail":
[...], "final_norm": {...}}``, and ``"draft": {"w"}`` with Medusa draft
heads), so this module needs no JAX.  Weights keep
the reference's ``[d_in, d_out]`` orientation (the port computes ``x @ w``
too, so nothing is transposed); the stacked ``unit`` axis splits into one
:class:`repro_torch.models.lm.Block` per repetition, whose parts are the
reference block's (``attn``/``ffn``/``norm1``/``norm2``, ``rec`` for an
RG-LRU block, ``mixer`` for a Mamba-2 block).  Every leaf must arrive in
the port's dtype for it: the float32 leaves of a bf16 model (the MoE
router, the RG-LRU gates and ``lam``, Mamba's ``a_log``, ``dt_bias`` and
``d_skip``) stay float32.  bfloat16 leaves
(numpy has no bfloat16; the reference hands over ``ml_dtypes`` arrays)
cross as their 16-bit patterns and are viewed back as ``torch.bfloat16``.  The
encoder-decoder (whisper) keeps the reference's stacked ``encoder`` and
``decoder`` leaves as they are.

The other direction names every leaf as the reference's tree does:
:func:`reference_leaves` lists the port's parameters in the reference's
``tree_flatten`` order with their key paths (:func:`keystr` gives
``jax.tree_util.keystr``'s string), a ``unit`` leaf as the list of its
repetitions' tensors; :func:`param_list` flattens that list, and is the
order of the optimizer state and of the gradients a train step returns;
:func:`to_reference_tree` rebuilds the reference's nested numpy tree from
any tensors aligned with it (parameters, gradients, moments), stacking a
``unit`` leaf's repetitions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, _block_parts, pattern_unit, with_draft
from repro_torch.models.whisper import Whisper


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _load(pdict, src: dict, device, rep=None) -> None:
    """Copy ``src[name]`` (its ``rep``-th slice when stacked) into each
    parameter of ``pdict``, checking shape and dtype."""
    for name, p in pdict.items():
        a = src[name] if rep is None else np.asarray(src[name])[rep]
        t = _tensor(a, device)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"parameter {name}: got {t.dtype} "
                             f"{tuple(t.shape)}, want {p.dtype} "
                             f"{tuple(p.shape)}")
        p.copy_(t)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None):
    """The port's :class:`LM` (or, for the audio family, :class:`Whisper`)
    holding the reference's parameters."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        params = Whisper(cfg, dev)
        for group in ("embed", "enc_norm", "final_norm"):
            _load(getattr(params, group), np_params[group], dev)
        for group in ("encoder", "decoder"):
            stack = getattr(params, group)
            for part in stack.parts():
                _load(getattr(stack, part), np_params[group][part], dev)
        return params
    params = LM(cfg, dev)
    _load(params.embed, np_params["embed"], dev)
    _load(params.final_norm, np_params["final_norm"], dev)
    unit, reps, tail = pattern_unit(cfg)
    for i in range(len(params.unit)):
        src = np_params["unit"][i]
        for r in range(reps):
            block = params.unit[i][r]
            for part in _block_parts(block):
                _load(getattr(block, part), src[part], dev, rep=r)
    for i, block in enumerate(params.tail):
        for part in _block_parts(block):
            _load(getattr(block, part), np_params["tail"][i][part], dev)
    if "draft" in np_params:
        if params.draft is None:          # heads the config does not count
            params = with_draft(params, {"w": torch.empty(
                np.shape(np_params["draft"]["w"]), dtype=cfg.param_dtype,
                device=dev)})
        _load(params.draft, np_params["draft"], dev)
    elif params.draft is not None:
        raise ValueError(f"the config asks for {cfg.spec_heads} draft heads "
                         f"but the parameters carry none")
    return params


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def reference_leaves(params) -> list:
    """The parameters as the reference's leaves, in its ``tree_flatten``
    order (dict keys sorted, lists in order): ``[(path, tensors,
    stacked)]``, ``tensors`` one tensor, or for a stacked ``unit`` leaf
    (``stacked`` True) its repetitions' tensors in order."""
    out = []
    if isinstance(params, Whisper):
        for group in ("decoder", "embed", "enc_norm", "encoder",
                      "final_norm"):
            mod = getattr(params, group)
            if group in ("encoder", "decoder"):
                for part in mod.parts():
                    pdict = getattr(mod, part)
                    out += [((group, part, name), [pdict[name]], False)
                            for name in sorted(pdict.keys())]
            else:
                out += [((group, name), [mod[name]], False)
                        for name in sorted(mod.keys())]
        return out
    if params.draft is not None:
        out.append((("draft", "w"), [params.draft["w"]], False))
    for group in ("embed", "final_norm"):
        pdict = getattr(params, group)
        out += [((group, name), [pdict[name]], False)
                for name in sorted(pdict.keys())]
    for i, block in enumerate(params.tail):
        for part in _block_parts(block):
            pdict = getattr(block, part)
            out += [(("tail", i, part, name), [pdict[name]], False)
                    for name in sorted(pdict.keys())]
    for i, blocks in enumerate(params.unit):
        for part in _block_parts(blocks[0]):
            out += [(("unit", i, part, name),
                     [getattr(b, part)[name] for b in blocks], True)
                    for name in sorted(getattr(blocks[0], part).keys())]
    return out


def param_list(params) -> list:
    """Every parameter tensor in the reference's leaf order (a ``unit``
    leaf's repetitions side by side)."""
    return [t for _, ts, _ in reference_leaves(params) for t in ts]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 (which numpy lacks) as
    float32, which holds it exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference_tree(params, tensors=None) -> dict:
    """The reference-structured numpy tree of ``tensors`` (aligned with
    :func:`param_list`; the parameters themselves when None): nested dicts
    and lists under the reference's keys, a ``unit`` leaf's repetitions
    stacked on a leading axis."""
    flat = list(param_list(params) if tensors is None else tensors)
    tree: dict = {}
    k = 0
    for path, ts, stacked in reference_leaves(params):
        arrs = [to_numpy(t) for t in flat[k:k + len(ts)]]
        k += len(ts)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = np.stack(arrs) if stacked else arrs[0]
    if k != len(flat):
        raise ValueError(f"{len(flat)} tensors for {k} parameters")
    return tree
