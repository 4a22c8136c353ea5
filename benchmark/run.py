"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m benchmark.run`` takes the same arguments.) The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with its limit, also the last lines of
standard error. ``--control`` judges the cell's control in place of the program's
results: the reference in bfloat16 (the configuration's float32, one
precision down) over the window's last call, for setting limits; it is
expected to come out not correct.

Exit codes: 0 a result was printed; 2 no CUDA device, or fewer than the cell
asks for; 3 JAX or the JAX package was loaded; anything else a failure.
Caches and outputs stay inside the checkout, under ``.bench_cache/``.
"""

import sys
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from benchmark import importcheck

    def jax_loaded(when: str) -> bool:
        found = importcheck.forbidden()
        if found:
            print(f"benchmark: {when}, modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return bool(found)

    if jax_loaded("at start"):
        return 3
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from benchmark import harness

    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[{time.perf_counter() - T_START:.1f} s] {msg}", file=sys.stderr, flush=True)

    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                              control=args.control, log=log)
    if jax_loaded("after the window"):
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (worst plane {c['plane']}), limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
