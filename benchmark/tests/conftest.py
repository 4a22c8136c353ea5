"""Shared fixtures of the benchmark's tests: a small CPU rehearsal of a cell
(its configuration at 48 x 48, a 110 x 100 TOPAZ stand-in, three members,
short chunks) and the card, decided inside a fixture."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {"grid.nx": 48, "grid.ny": 48}
#: the dataset cells, held out of BENCHMARK.json until the ERA5 reader lets
#: them be measured (PERF.md), rehearsed here with their files
HELD_BACK = [
    {"name": "arctic_10km.forecast", "config": "arctic_10km", "traffic": "forecast", "chips": 1, "why": "held back"},
    {"name": "arctic_10km.ensemble16", "config": "arctic_10km", "traffic": "ensemble16", "chips": 1,
     "why": "held back"},
]
RESOLUTION = {"arctic_10km": 120e3, "arctic_5km": 100e3}


def bench_with_held_back(path: Path) -> Path:
    """BENCHMARK.json with the held-back cells, written to ``path``."""
    import json

    from benchmark import harness

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += HELD_BACK
    path.write_text(json.dumps(bench))
    return path


def small_spec(workload: str, bench_file: Path) -> dict:
    from benchmark import harness

    spec = copy.deepcopy(harness.load_cell(workload, bench_file))
    traffic = spec["traffic"]
    if isinstance(traffic.get("chunk"), int):
        traffic["chunk"] = 3
    if traffic["driver"] == "ensemble":
        traffic["members"] = 3
    traffic["trace_calls"] = 1
    return spec


@pytest.fixture(scope="session")
def rehearse(tmp_path_factory):
    """run(workload, seed=..., calls=..., trace=..., control=...): the result
    of a CPU rehearsal of the cell, its inputs cached for the session."""
    from benchmark import harness, inputs

    cache = tmp_path_factory.mktemp("bench_cache")
    bench_file = bench_with_held_back(cache / "BENCHMARK.json")

    def run(workload, seed=20231, calls=2, trace=False, control=False):
        spec = small_spec(workload, bench_file)
        shape, inputs.TOPAZ_SHAPE = inputs.TOPAZ_SHAPE, (100, 110)
        try:
            extra = dict(SMALL, **{"grid.resolution": RESOLUTION[spec["cell"]["config"]]})
            return harness.run_cell(spec, seed, 1.0, trace, device="cpu", calls=calls, control=control,
                                    cache=cache, extra_options=extra, log=lambda m: None)
        finally:
            inputs.TOPAZ_SHAPE = shape

    return run


@pytest.fixture
def card():
    """Skips without a CUDA device; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m gpu benchmark/tests)")
    return torch.device("cuda")
