"""The port's benchmark: one run of one cell.

  python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device` (and with `--trace 1` its
`busy_s` and `window_s`, and `breakdown`), and last `checks`: each number
the output check compared, beside its limit. The same numbers end
standard error.

Without CUDA, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result
and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the build and kernel caches at fixed paths inside the checkout, so only
# a cell's first run there builds; the port builds into build/repro_torch
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("OMP_NUM_THREADS", "1")
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    cell = harness.Cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    out = cell.driver().run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda",
                            t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in the measuring process: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
