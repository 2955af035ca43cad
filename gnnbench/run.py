"""Run one cell of the benchmark of ``repro_torch`` (``BENCHMARK.json``):

    python3 gnnbench/run.py --workload sage-products-b1000 --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout, on a machine with the NVIDIA card(s) the
cell asks for. Progress goes to standard error, the device's name and
power limit to an earlier line of standard output, and the result as one
JSON object on the last line of standard output; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the result's last key. A run that finds no card, or
fewer than the cell asks for, or JAX or the JAX package ``repro`` loaded
in this process, exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"power limit not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"power limit not read ({out.stderr.strip()})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gnnbench import harness

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card and has no "
            "CPU fallback")
        return 2
    import repro_torch  # noqa: F401  (the program under test, or no run)

    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; {power_limit()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START, "cuda", log)
    # after the window, in the process that prints the result
    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
