"""Carry the reference's parameters across: ``params_from_jax``.

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
cross as their 16-bit patterns and are viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, _block_parts, pattern_unit, with_draft


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


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's :class:`LM` holding the reference's parameters."""
    dev = resolve_device(device)
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
