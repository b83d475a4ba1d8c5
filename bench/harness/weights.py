"""Weights made from the seed, on the device, in the type they are served in.

The benchmark makes the weights itself and hands the same tensors to both
sides: the program gets them placed in its parameter module
(:func:`program_params`), the reference reads them by the names below.
Names and shapes come from the configuration file alone:

- ``embed.table [vocab, d]`` (and ``embed.head [d, vocab]`` when untied);
- ``layers.<i>.norm1.scale|bias``, ``layers.<i>.norm2.scale|bias``,
  ``final_norm.scale|bias`` ``[d]``: scale 1, bias 0;
- ``layers.<i>.attn.wq [d, H*hd]``, ``wk``/``wv [d, Hkv*hd]``, ``wo [H*hd,
  d]``, applied as ``x @ w``;
- ``layers.<i>.ffn.w_up [d, d_ff]`` (and ``w_gate`` when gated),
  ``w_out [d_ff, d]``.

Matrices are normal draws scaled by ``1/sqrt(fan_in)`` (the table by
``1/sqrt(d)``).  All matrices of one scale lie in one flat buffer, drawn
by one call of a ``torch.Generator`` on the device seeded with the run's
seed and scaled in place, so a run makes its weights in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.yardstick.model_cost import widths

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def leaves(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every weight; ``init`` is ``"one"``,
    ``"zero"`` or ``"fan_in=<n>"``."""
    w = widths(cfg)
    d, q, kv = w.d_model, w.heads * w.head_dim, w.kv_heads * w.head_dim
    out = [("embed.table", (w.vocab, d), f"fan_in={d}")]
    if not w.tied:
        out.append(("embed.head", (d, w.vocab), f"fan_in={d}"))
    for i in range(w.layers):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "one"),
                (p + "norm1.bias", (d,), "zero"),
                (p + "attn.wq", (d, q), f"fan_in={d}"),
                (p + "attn.wk", (d, kv), f"fan_in={d}"),
                (p + "attn.wv", (d, kv), f"fan_in={d}"),
                (p + "attn.wo", (q, d), f"fan_in={q}"),
                (p + "norm2.scale", (d,), "one"),
                (p + "norm2.bias", (d,), "zero")]
        if w.gated:
            out.append((p + "ffn.w_gate", (d, w.d_ff), f"fan_in={d}"))
        out += [(p + "ffn.w_up", (d, w.d_ff), f"fan_in={d}"),
                (p + "ffn.w_out", (w.d_ff, d), f"fan_in={w.d_ff}")]
    out += [("final_norm.scale", (d,), "one"),
            ("final_norm.bias", (d,), "zero")]
    return out


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg`` from ``seed``: one flat buffer per
    initialiser, views into it by name."""
    dtype = DTYPES[cfg["torch_dtype"]]
    groups: Dict[str, List[Tuple[str, tuple]]] = {}
    for name, shape, init in leaves(cfg):
        groups.setdefault(init, []).append((name, shape))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for init in sorted(groups):
        members = groups[init]
        total = sum(math.prod(s) for _, s in members)
        if init == "one":
            flat = torch.ones(total, dtype=dtype, device=device)
        elif init == "zero":
            flat = torch.zeros(total, dtype=dtype, device=device)
        else:
            fan_in = int(init.split("=")[1])
            flat = torch.randn(total, generator=gen, dtype=dtype,
                               device=device)
            flat.mul_(1.0 / math.sqrt(fan_in))
        off = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
    return out


def _program_name(name: str, unit: str) -> str:
    """The program's parameter name ``unit.<k>.<r>.<part>.<leaf>`` →
    the benchmark's ``layers.<r*len(unit)+k>.<part>.<leaf>``."""
    parts = name.split(".")
    if parts[0] == "unit":
        k, r = int(parts[1]), int(parts[2])
        return ".".join(["layers", str(r * len(unit) + k)] + parts[3:])
    return name


def program_params(lm_module, cfg_port, weights: Dict[str, torch.Tensor]):
    """The program's parameter module for ``cfg_port`` with every
    parameter a view of ``weights`` (no copy).  ``lm_module`` is the
    program's ``repro_torch.models.lm``.  Raises where a name or shape
    disagrees."""
    params = lm_module.LM(cfg_port, torch.device("meta"))
    unit = cfg_port.block_pattern
    names = set()
    for module_name, module in params.named_modules():
        if not isinstance(module, torch.nn.ParameterDict):
            continue
        for leaf, p in list(module.items()):
            full = _program_name(f"{module_name}.{leaf}", unit)
            names.add(full)
            t = weights.get(full)
            if t is None or tuple(t.shape) != tuple(p.shape) \
                    or t.dtype != p.dtype:
                have = None if t is None else (tuple(t.shape), t.dtype)
                raise ValueError(
                    f"program parameter {module_name}.{leaf} "
                    f"{tuple(p.shape)} {p.dtype} has no matching weight "
                    f"{full}: {have}")
            module[leaf] = torch.nn.Parameter(t, requires_grad=False)
    extra = set(weights) - names
    if extra:
        raise ValueError(f"weights the program does not take: "
                         f"{sorted(extra)[:5]}")
    return params
