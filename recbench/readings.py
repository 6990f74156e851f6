"""Readings behind the limits of `correct`: for each seed, the numbers
that a sound run of the program gives (a short window, then the same
comparison a run makes) and those of the control (the plain reference
one precision below the configuration's, put in the program's place).
The benchmark's own runs never run the control.

    python recbench/readings.py --workload <name> --seconds <s> SEED...

Prints one JSON line per seed and side, and the largest reading of each
number on each side at the end.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CACHE = ROOT / "recbench" / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def readings(cell, seeds, seconds: float, device: str, control: bool = True):
    """{"program": [numbers per seed], "control": [...]}."""
    from recbench import harness
    driver = harness.load_driver(cell.traffic["driver"])
    out = {"program": [], "control": []}
    for seed in seeds:
        t0 = time.perf_counter()
        state = driver.setup(cell, seed, device)
        win = driver.window(state, seconds)
        driver.release(state)
        prog = driver.check(state, win)
        t1 = time.perf_counter()
        out["program"].append(prog)
        print(json.dumps({"seed": seed, "side": "program", "s": t1 - t0,
                          **prog}), flush=True)
        if control:
            ctrl = driver.control(state)
            out["control"].append(ctrl)
            print(json.dumps({"seed": seed, "side": "control",
                              "s": time.perf_counter() - t1, **ctrl}),
                  flush=True)
        del state, win
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    from recbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    harness.require_cards(torch, cell.chips)
    res = readings(cell, args.seeds, args.seconds, "cuda",
                   control=not args.no_control)
    for side, rows in res.items():
        if rows:
            print(json.dumps({"side": side, "largest": {
                k: max(r[k] for r in rows) for k in rows[0]},
                "smallest": {k: min(r[k] for r in rows) for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
