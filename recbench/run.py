"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python recbench/run.py --workload <name> --seed <n> --seconds <s>
                           --trace <0|1>

The cell's inputs come from the seed; set-up (imports, the kernels'
build or load, inputs, warm-up) is timed from the start of this script;
the window runs for `--seconds`; with `--trace 1` a stretch after the
window is profiled and the cell's per-layer metrics are read from it.
Without as many CUDA cards as the cell asks for it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "recbench" / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from recbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    harness.require_cards(torch, cell.chips)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"recbench: the run loaded {', '.join(found)}; nothing it "
              f"runs may load JAX or the JAX package", file=sys.stderr)
        return 3
    harness.report_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
