"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro`` module for module (``repro_torch.fabric.
scheduler`` is the port of ``repro.fabric.scheduler``) and imports only
``torch`` and ``numpy``.  Every Pallas kernel on a ported path is a CUDA
kernel written for Hopper (``repro_torch.kernels.csrc``), built at first
use; on a CPU tensor each kernel wrapper takes its plain PyTorch version.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise (``meta`` builds shapes alone, nothing allocated, as the
    step builders' specs need).  Raises when a CUDA device is asked for
    and none is present — the port never falls back to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
