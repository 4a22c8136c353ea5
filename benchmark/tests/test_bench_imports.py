"""The import check: nothing the benchmark runs loads JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
program either."""

import json
import subprocess
import sys

from benchmark import harness, importcheck

ROOT = str(harness.ROOT)


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": ROOT})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole():
    mods = {"nextsim_tpu_torch": 1, "nextsim_tpu_torch.ops": 1, "jaxtyping": 1, "benchmark": 1}
    assert importcheck.forbidden(modules=mods) == []
    assert importcheck.forbidden(modules=dict(mods, **{"nextsim_tpu.model": 1, "jax.numpy": 1})) == \
        ["jax.numpy", "nextsim_tpu.model"]


def test_the_reference_loads_nothing_of_the_program_or_jax():
    loaded = _loaded_after("import benchmark.reference.model, benchmark.check, benchmark.inputs, benchmark.bounds")
    assert importcheck.forbidden(importcheck.FORBIDDEN + ("nextsim_tpu_torch",), loaded) == []


def test_a_run_loads_no_jax():
    """A whole rehearsal of a cell in a fresh process: program, window,
    readers and check."""
    code = """
import sys
sys.path.insert(0, "benchmark/tests")
import conftest
from pathlib import Path
import tempfile
from benchmark import harness
spec = conftest.small_spec("arctic_5km.chunk30", harness.ROOT / "BENCHMARK.json")
extra = dict(conftest.SMALL, **{"grid.resolution": 100e3})
with tempfile.TemporaryDirectory() as d:
    res = harness.run_cell(spec, 5, 1.0, True, device="cpu", calls=1, cache=Path(d), extra_options=extra,
                           log=lambda m: None)
assert res["correct"], res["checks"]
"""
    loaded = _loaded_after(code)
    assert "nextsim_tpu_torch" in loaded
    assert importcheck.forbidden(modules=loaded) == []


def test_run_py_refuses_without_a_card():
    """No CUDA device here: exit 2 and no result on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "arctic_5km.chunk30", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
