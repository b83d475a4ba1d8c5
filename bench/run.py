"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
correctness limits and metric readers are found by the names in
``BENCHMARK.json``.  The last line of standard output is the result
object; the last lines of standard error are the numbers the correctness
check compared, each beside its limit.  Without as many CUDA cards as the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, the run prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache a run could write stays inside the checkout, at a fixed
    # path; the program builds its kernels into build/kernels itself
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench.harness import main as harness
    from bench.harness.spec import Cell

    with open(ROOT / "BENCHMARK.json") as f:
        cell = Cell(json.load(f), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda:0"),
                                T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
