"""The benchmark on the card (marker ``gpu``; skipped without a CUDA
device): a run of each cell through ``run.py`` at the benchmark's
``run_seconds``, and the control at the cell's own size and window, which
has to come out not correct."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = str(BENCH["run_seconds"])


def _run(*args, timeout=1200):
    out = subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_is_correct(card, workload):
    res = _run("--workload", workload, "--seed", "2147483659", "--seconds", SECONDS, "--trace", "0")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(card, workload):
    res = _run("--workload", workload, "--seed", "2147483671", "--seconds", SECONDS, "--trace", "0", "--control")
    assert not res["correct"], res["checks"]
