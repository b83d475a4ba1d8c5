"""The control on the card at each cell's own size: the program's numbers
hold within the cell's limits, and the reference in float8 e4m3, put in the
program's place, fails at least one of them, on three seeds.  Runs each
cell's full window; ``python -m pytest bench/tests -m chip`` on a card."""

import json
import time

import pytest

from bench.tests.conftest import ROOT

CELLS = ("stablelm-1.6b.long_chat", "starcoder2-15b.repo_complete")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_holds(chip, name):
    import gc

    import torch

    from bench.harness import check, loop
    from bench.harness.spec import Cell

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = Cell(bench, name, ROOT)
    limits = cell.check["limits"]
    for seed in SEEDS:
        record, weights, _ = loop.drive(cell, seed, bench["run_seconds"],
                                        False, chip, time.perf_counter())
        gc.collect()
        torch.cuda.empty_cache()
        out = check.control(cell, record, weights, seed, chip)
        del record, weights
        gc.collect()
        torch.cuda.empty_cache()
        assert all(out["program"][k] <= limits[k] for k in limits), out
        assert any(out["control"][k] > limits[k] for k in limits), out
