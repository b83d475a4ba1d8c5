"""Fixtures of the benchmark's own tests (``python -m pytest bench/tests``).

``tiny_bench`` lays out a benchmark in a temporary directory: the real
metric readers beside a configuration of the stablelm family at toy
widths, a small traffic mix and its cell's limits, all new files found by
name.  Tests marked ``chip`` need a CUDA card; the ``chip`` fixture decides
whether there is one when the test runs, never at import.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_WIDTHS = {"num_hidden_layers": 2, "hidden_size": 48,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "intermediate_size": 128, "vocab_size": 384}
TINY_PORT = {"name": "tiny", "n_layers": 2, "d_model": 48, "n_heads": 4,
             "n_kv_heads": 2, "d_ff": 128, "vocab_size": 384, "head_dim": 12}
TINY_MIX = {"loop": "closed", "clients": 4,
            "engine": {"max_slots": 4, "t_max": 64, "page_size": 8},
            "sizes": 8, "pairing_seed": 0,
            "prompt": {"median": 16, "sigma": 0.4, "min": 8, "max": 40},
            "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 12},
            "peak_steps": 12, "trace_seconds": 0.5}
# set from this toy cell's own readings on the CPU (bfloat16, 1.5 s
# windows, every finished request compared, seeds 2**31 .. 2**31 + 11):
# the program read at most 0.036 (served_gap) and 0.076 (logit_err), the
# fp8 control at least 0.257 and 0.520
TINY_LIMITS = {"served_gap": 0.1, "logit_err": 0.2}
END_TO_END = ("output_tok_s", "tpot_p95_ms", "ttft_p80_ms", "peak_mem_gib",
              "setup_s")
PER_LAYER = ("decode_step_ms", "admit_step_ms", "fabric_bytes_per_tok", "mfu",
             "hbm_share", "gather_roofline", "scatter_roofline",
             "device_idle_share")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def tiny_config(dtype="bfloat16", gated=True):
    base = "stablelm-1.6b" if gated else "starcoder2-15b"
    with open(BENCH / "configs" / f"{base}.json") as f:
        cfg = json.load(f)
    cfg.update(TINY_WIDTHS, name="tiny", torch_dtype=dtype)
    cfg["port"] = dict(cfg["port"], **TINY_PORT,
                       dtype=dtype if dtype != "bfloat16" else "bfloat16")
    return cfg


@pytest.fixture
def tiny_bench(tmp_path):
    """``(spec, root, bench)`` of a one-cell benchmark ``tiny.mini``."""
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for sub in ("configs", "traffic", "cells"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (bench / "traffic" / "mini.json").write_text(json.dumps(TINY_MIX))
    (bench / "cells" / "tiny.mini.json").write_text(
        json.dumps({"requests": 64, "limits": TINY_LIMITS}))
    spec = {"configs": [{"name": "tiny", "file": "bench/configs/tiny.json"}],
            "workloads": [{"name": "tiny.mini", "config": "tiny",
                           "traffic": "mini", "chips": 1}],
            "end_to_end": [{"name": n, "unit": "u"} for n in END_TO_END],
            "per_layer": [{"name": n, "unit": "u"} for n in PER_LAYER]}
    return spec, root, bench
