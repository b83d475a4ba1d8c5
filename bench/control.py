"""Readings that set a cell's correctness limits: the program and the control.

    python3 bench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: one run of the cell's window, then on the
same sample of finished requests the program's two numbers
(``served_gap``, ``logit_err``) and the fp8 control's
(:func:`bench.harness.check.control`).  One JSON line a seed on standard
output.  The lower reading of a number is the largest the program gives
over a dozen seeds or more, the upper the smallest the control gives; the
limit in ``bench/cells/<name>.json`` lies between them.  The benchmark's
own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench.harness import check, loop
    from bench.harness.spec import Cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        cell = Cell(json.load(f), args.workload, ROOT)
    dev = torch.device("cuda:0")
    t = T_START
    for seed in args.seeds:
        record, weights, _ = loop.drive(cell, seed, args.seconds, False, dev,
                                        t)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out = check.control(cell, record, weights, seed, dev)
        out.update(seed=seed, setup_s=record.setup_s,
                   window_s=record.window_s, window_tokens=record.tokens,
                   check_s=time.perf_counter() - t1)
        print(json.dumps(out), flush=True)
        del record, weights
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
