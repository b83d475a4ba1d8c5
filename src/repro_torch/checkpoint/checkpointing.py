"""Checkpointing: atomic, resumable, and in the reference's format (port of
``repro.checkpoint.checkpointing``).

A state is flattened to its leaves keyed by the reference's key strings
(``jax.tree_util.keystr`` of the leaf's path in the reference's tree):
dicts by sorted key, lists by index, an :class:`repro_torch.optim.
OptState` by field (``.step``, ``.m``, ``.v``, ``.master``), a model's
parameters as :func:`repro_torch.convert.reference_leaves` names them (a
``unit`` leaf's repetitions stacked into one array).  Leaves go to host
numpy and into ``step_%08d/arrays.npz`` beside a JSON manifest; bfloat16
leaves are stored as float32, which holds them exactly.  A save writes a
temporary directory and renames it into place, so a failure mid-save
never corrupts the latest checkpoint.  A checkpoint written by either
package restores in the other.

Restore maps the arrays back by key onto a template state whose tensors
are live: each array is cast to its leaf's dtype and copied into the
leaf in place (a stacked leaf split over its repetitions), so every leaf
of the template — parameters, moments, master copy, step — holds the
checkpoint's values and nothing of what it held before survives.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import keystr, reference_leaves, to_numpy
from repro_torch.models.lm import LM
from repro_torch.models.whisper import Whisper
from repro_torch.optim.optimizer import OptState


def _leaves(tree, prefix: str = "") -> list:
    """``[(key, tensors, stacked)]`` of a state tree in the reference's
    flatten order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, [tree], False)]
    if isinstance(tree, (LM, Whisper)):
        return [(prefix + keystr(path), ts, stacked)
                for path, ts, stacked in reference_leaves(tree)]
    if isinstance(tree, OptState):
        out = [(prefix + ".step", [tree.step], False)]
        for field in ("m", "v", "master"):
            flat = getattr(tree, field)
            if flat is None:
                continue
            k = 0
            for path, n, stacked in tree.layout:
                out.append((f"{prefix}.{field}{keystr(path)}",
                            flat[k:k + n], stacked))
                k += n
        return out
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in _leaves(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, sub in enumerate(tree)
                for leaf in _leaves(sub, f"{prefix}[{i}]")]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix or 'the root'}")


def _flatten(tree) -> dict:
    flat = {}
    for key, ts, stacked in _leaves(tree):
        arrs = [to_numpy(t) for t in ts]
        flat[key] = np.stack(arrs) if stacked else arrs[0]
    return flat


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(state)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat.keys()),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, step: int,
                       template: Any) -> tuple[Any, dict]:
    """Copy checkpoint ``step`` into ``template``'s tensors in place and
    return ``(template, extra)``.  A missing leaf raises ``KeyError``, a
    shape that differs ``ValueError``; both are checked for every leaf
    before any is written."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(template)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {}
        for key, ts, stacked in leaves:
            if key not in npz.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arrays[key] = npz[key]                 # each read once
            want = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            if tuple(arrays[key].shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arrays[key].shape} vs {want}")
    for key, ts, stacked in leaves:
        arr = torch.from_numpy(arrays.pop(key))
        for t, part in zip(ts, arr if stacked else [arr]):
            t.copy_(part)                          # cast on the way in
    return template, manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``every`` steps."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, state, extra: Optional[dict] = None):
        if step % self.every:
            return None
        path = save_checkpoint(self.directory, step, state, extra)
        self._gc()
        return path

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
