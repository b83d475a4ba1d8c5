"""One run of the harness on the CPU at toy widths: the result line, files
found by name, the CLI's refusal without a card, and faults in the timed
path that the check has to catch."""

import json
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import main, spec
from bench.tests.conftest import ROOT

CPU = torch.device("cpu")


def _run(tiny_bench, seed=2 ** 31 + 5, seconds=1.5):
    s, root, bench = tiny_bench
    cell = spec.Cell(s, "tiny.mini", root, bench)
    return main.run(cell, seed, seconds, False, CPU, time.perf_counter())


def test_result_line_has_its_keys(tiny_bench):
    result, lines = _run(tiny_bench)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    json.loads(json.dumps(result))
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] > 4
    assert {"output_tok_s", "tpot_p95_ms", "ttft_p80_ms",
            "setup_s"} <= set(result["metrics"])
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["check"]) == {"served_gap", "logit_err"}
    assert [ln.split()[0] for ln in lines] == ["served_gap", "logit_err"]
    assert all(" limit " in ln for ln in lines)


def test_a_new_metric_config_and_mix_are_found_by_name(tiny_bench):
    s, root, bench = tiny_bench
    (bench / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.steps) / run.window_s\n")
    (bench / "metrics" / "never_read.py").write_text(
        "def read(run):\n    return None\n")
    s["end_to_end"] += [{"name": "steps_per_s", "unit": "1/s"},
                        {"name": "never_read", "unit": "1"}]
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny2"
    (bench / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "mini.json").read_text())
    (bench / "traffic" / "mini2.json").write_text(json.dumps(mix))
    (bench / "cells" / "tiny2.mini2.json").write_text(
        (bench / "cells" / "tiny.mini.json").read_text())
    s["configs"].append({"name": "tiny2", "file": "bench/configs/tiny2.json"})
    s["workloads"].append({"name": "tiny2.mini2", "config": "tiny2",
                           "traffic": "mini2", "chips": 1})
    cell = spec.Cell(s, "tiny2.mini2", root, bench)
    assert cell.config["name"] == "tiny2"
    result, _ = main.run(cell, 11, 1.0, False, CPU, time.perf_counter())
    assert result["metrics"]["steps_per_s"]["unit"] == "1/s"
    assert "never_read" not in result["metrics"]
    with pytest.raises(KeyError):
        spec.Cell(s, "tiny.nothing", root, bench)


def test_a_metric_listing_cells_is_read_only_there(tiny_bench):
    s, root, bench = tiny_bench
    s["end_to_end"][0]["workloads"] = ["some.other"]
    cell = spec.Cell(s, "tiny.mini", root, bench)
    assert s["end_to_end"][0]["name"] not in [m["name"]
                                              for m in cell.end_to_end]


def test_the_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "stablelm-1.6b.long_chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import repro_torch  # noqa: F401  (its name begins with "repro")
    assert "repro" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in main.forbidden_modules()


@pytest.mark.parametrize("seconds,peak_steps", [(0.0, 5), (1.0, 3)])
def test_the_work_peak_is_read_after_a_fixed_count_of_steps(
        tiny_bench, monkeypatch, seconds, peak_steps):
    """The work's peak is read once the window's first ``peak_steps`` steps
    have run, whether the window closes before them (the run steps on
    outside it) or long after; the window's records leave the extra steps
    out."""
    from bench.harness import loop
    from repro_torch.serving.engine import ServingEngine
    s, root, bench = tiny_bench
    mix = json.loads((bench / "traffic" / "mini.json").read_text())
    mix["peak_steps"] = peak_steps
    (bench / "traffic" / "mini.json").write_text(json.dumps(mix))
    taken = []
    real = ServingEngine.step
    monkeypatch.setattr(ServingEngine, "step",
                        lambda self: taken.append(1) or real(self))
    monkeypatch.setattr(loop, "_peak", lambda device: len(taken))
    cell = spec.Cell(s, "tiny.mini", root, bench)
    record, _, _ = loop.drive(cell, 2 ** 31 + 9, seconds, False, CPU,
                              time.perf_counter())
    assert record.peak_steps == peak_steps
    assert record.work_peak_bytes == 1 + peak_steps     # set-up's step too
    assert record.memory_peak_bytes == len(taken)
    if seconds == 0.0:
        assert record.steps == [] and record.window_s == 0.0
        assert len(taken) == 1 + peak_steps
    else:
        assert len(record.steps) > peak_steps
        assert len(taken) == 1 + len(record.steps)


# -- faults in the timed path ------------------------------------------------

def _alter_tokens(monkeypatch):
    """A token altered where it is produced: each step's newest token of
    every live request is served one id off."""
    from repro_torch.serving.engine import ServingEngine
    real = ServingEngine._step_inner

    def step(self, step_no):
        live = [r for r in self.active if r is not None]
        n = real(self, step_no)
        vocab = self.cfg.vocab_size
        for r in live + [r for r in self.active if r is not None]:
            if r.generated:
                r.generated[-1] = (r.generated[-1] + 1) % vocab
        return n
    monkeypatch.setattr(ServingEngine, "_step_inner", step)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: admission's install of the
    prompts' K/V into the pool writes nothing."""
    from repro_torch.fabric.paged_kv import PagedKVCache
    monkeypatch.setattr(PagedKVCache, "admit_wave",
                        lambda self, entries, stats=None, burst=None: None)


def _half_batch(monkeypatch):
    """Half of the batch left out: the decode computes the first half of
    the slots and serves those rows to the other half too."""
    from repro_torch.models import api

    real = api.decode_fn

    def decode(params, token, caches, pos, cfg, **kw):
        logits, caches = real(params, token, caches, pos, cfg, **kw)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[logits.shape[0] - half:] = logits[:half]
        return logits, caches
    monkeypatch.setattr(api, "decode_fn", decode)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch])
def test_a_fault_in_the_timed_path_is_not_correct(tiny_bench, monkeypatch,
                                                  fault):
    fault(monkeypatch)
    result, lines = _run(tiny_bench)
    assert result["correct"] is False, lines
