"""Readings for the limits of a cell's check whose controls the cell's own
driver makes (``cell.variant``): the program and its controls, on many
seeds in one process.

    python3 perfbench/controls.py --workload <name> --seeds 1,2,3 \\
        --variants program,tf32,bfloat16 [--seconds 2] [--out build/readings.jsonl]

Each (variant, seed) sets the cell up with ``cell.variant`` the variant
(``program``: none), runs a short window at the cell's own load, and prints
one JSON line with every number compared and the window's calls. The
variants each driver knows are in its docstring: ``recognize_lines``
``tf32`` and ``bfloat16``, ``trba_train`` ``reference_bf16`` and
``half_batch``.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import harness

    out = open(args.out, "a") if args.out else None
    for variant in args.variants.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            cell = harness.load_cell(ROOT, args.workload, seed, args.seconds, False, args.device,
                                     None if variant == "program" else variant)
            driver = harness.load_module(cell.file("drivers", f"{cell.traffic['driver']}.py"))
            session = driver.setup(cell)
            calls = 0
            if getattr(session, "runs_window", True):  # a reference control runs no window
                calls = harness.measure(session, cell.seconds, cell.device).calls
            session.free()
            check = session.check()
            line = {"workload": args.workload, "variant": variant, "seed": seed, "calls": calls,
                    "correct": check.correct, "seconds": time.perf_counter() - t0,
                    "numbers": check.as_dict(), "notes": check.notes}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del session
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
