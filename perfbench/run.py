"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. The run makes its
inputs and weights from the seed on the card, warms up the cell's shapes,
measures for ``--seconds`` (with ``--trace 1``: traces the traffic's
``trace_calls`` calls instead), compares what the timed calls produced with
the plain reference, and prints one JSON object as the last line of standard
output (the numbers compared, each beside its limit, also as the last lines
of standard error). It exits non-zero, printing no result, without enough
CUDA cards, or when JAX or the JAX package ``manuscript_tpu`` was loaded.
Kernel builds and caches stay in ``build/`` of the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no weights fetched or found."""
    build = ROOT / "build"
    os.environ["MANUSCRIPT_TPU_KERNEL_CACHE"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "perfbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "perfbench" / "torch_extensions")
    os.environ["MANUSCRIPT_TPU_CACHE"] = str(build / "perfbench" / "no_weights")
    os.environ["MANUSCRIPT_TPU_NO_DOWNLOAD"] = "1"
    os.environ["MANUSCRIPT_TPU_ALLOW_RANDOM_INIT"] = "1"
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench import guard, harness

    cell = harness.load_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    from manuscript_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = harness.run(cell, T0)
    result, window = out["result"], out["window"]
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    if window is not None:
        ms = sorted(1e3 * s for s in window.call_seconds)
        print(f"perfbench: {window.calls} timed calls, {window.work} {window.unit}, "
              f"{window.seconds:.3f} s window, setup {out['setup_s']:.3f} s; call ms "
              f"min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}")
    for note in out["check"].notes:
        print(f"note {note}", file=sys.stderr)
    for name, value, limit in out["check"].numbers:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
