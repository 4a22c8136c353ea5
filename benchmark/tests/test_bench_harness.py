"""The benchmark's harness on the CPU: BENCHMARK.json resolves to its files,
the result line's keys and types, a rehearsal of each traffic mix through
the plain path at a small size, and the comparison failing on planted
faults and on the control."""

import importlib
import json
import math
import sys

import pytest
import torch

from benchmark import check, drivers, harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD_BACK = ["arctic_10km.forecast", "arctic_10km.ensemble16"]


def test_every_cell_and_metric_resolves_to_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        spec = harness.load_cell(w["name"])
        kind = drivers.load(spec["traffic"]["driver"])
        assert callable(kind.Driver) and callable(kind.compare)
        assert kind.steps_a_call_bound(spec["config"]["options"], spec["traffic"]) >= 1
        assert spec["limits"] and set(spec["limits"]) <= set(check.ORDER)
        for limit in spec["limits"].values():
            assert math.isfinite(check.limit_of(limit)[0])
        assert {m["name"] for m in spec["end_to_end"]} == {"model_days_per_hour", "setup_s"}
        assert spec["per_layer"], w["name"]
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_new_metric_resolves_from_a_new_file_alone(tmp_path, monkeypatch):
    """A later metric is a file of its own and an entry: nothing that is
    there is edited."""
    import benchmark.metrics

    (tmp_path / "dummy_metric_ms.py").write_text("def read(ctx):\n    return 1e3 * ctx.window_s / ctx.steps\n")
    monkeypatch.setattr(benchmark.metrics, "__path__", list(benchmark.metrics.__path__) + [str(tmp_path)])
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "dummy_metric_ms", "unit": "ms", "better": "lower", "source": "host_clock", "layer": "device",
         "moves": "model_days_per_hour", "workloads": ["arctic_5km.chunk30"]}])
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    spec = harness.load_cell("arctic_5km.chunk30", bench_file)
    assert "dummy_metric_ms" in [m["name"] for m in spec["per_layer"]]
    assert harness.reader("dummy_metric_ms")(type("C", (), {"window_s": 2.0, "steps": 4})) == 500.0
    sys.modules.pop("benchmark.metrics.dummy_metric_ms", None)


def test_clamped_chunk_is_the_run_loops(rehearse):
    """The forecast's calls take the length ``Simulator.run`` clamps
    arctic_10km.cfg's 10 steps a call to, 9 (moorings every 108 steps,
    drifters every 216, snapshots every 432); its data span is sized for
    the unclamped 10."""
    opts = json.loads((harness.BENCH / "configs" / "arctic_10km.json").read_text())["options"]
    assert drivers.load("chunks").steps_a_call_bound(opts, {"chunk": "clamped"}) == 10
    assert rehearse("arctic_10km.forecast")["steps"] == 2 * 9


def test_seed_draws_the_start_hour_and_wind(tmp_path):
    from benchmark.tests import conftest

    a = harness.load_cell("arctic_10km.forecast", conftest.bench_with_held_back(tmp_path / "BENCHMARK.json"))
    c = harness.load_cell("arctic_5km.chunk30")
    seed = 2**31 + 977
    o1, o2 = (harness.run_options(a, seed, tmp_path) for _ in range(2))
    assert o1 == o2 and o1["simul.time_init"].startswith("2015-10-16 ")
    w = harness.run_options(c, seed, tmp_path)
    assert 8.0 <= math.hypot(w["ideal_simul.constant_wind_u"], w["ideal_simul.constant_wind_v"]) <= 12.0
    assert harness.run_options(c, seed + 1, tmp_path) != w


def _check_line(res):
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit", "plane"} and math.isfinite(c["limit"])
    json.dumps(res)


@pytest.mark.parametrize("workload", CELLS + HELD_BACK)
def test_rehearsal_through_the_plain_path_is_correct(rehearse, workload):
    res = rehearse(workload)
    _check_line(res)
    assert set(res["metrics"]) == {"model_days_per_hour", "setup_s"}
    assert res["correct"], res["checks"]


def test_traced_rehearsal_reports_per_layer_metrics(rehearse):
    res = rehearse("arctic_5km.chunk30", trace=True)
    _check_line(res)
    assert "init_s" in res["metrics"] and res["device"]["window_s"] > 0
    assert "model_days_per_hour" not in res["metrics"]
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS + HELD_BACK)
def test_control_is_not_correct(rehearse, workload):
    """bfloat16 in place of float32: the program's own path for a
    Simulator, the reference put in the program's place for the ensemble."""
    res = rehearse(workload, control=True)
    assert not res["correct"], res["checks"]


def _unchanged(self, state, forcing, tinfo, nest=None):
    from nextsim_tpu_torch.model import checks

    return state, {}, checks.violations(state, use_young_ice=self.dyn.use_young_ice)


def _altered(real):
    def step(self, state, forcing, tinfo, nest=None):
        state, diag, viol = real(self, state, forcing, tinfo, nest)
        return state.replace(thick=state.thick * 1.1), diag, viol
    return step


def test_a_step_that_returns_its_state_unchanged_is_not_correct(rehearse, monkeypatch):
    from nextsim_tpu_torch.model.simulator import Simulator

    monkeypatch.setattr(Simulator, "raw_step_fn", _unchanged)
    assert not rehearse("arctic_5km.chunk30")["correct"]


def test_an_answer_altered_where_it_is_made_is_not_correct(rehearse, monkeypatch):
    from nextsim_tpu_torch.model.simulator import Simulator

    monkeypatch.setattr(Simulator, "raw_step_fn", _altered(Simulator.raw_step_fn))
    assert not rehearse("arctic_5km.chunk30")["correct"]


def _damage_in_a_quadrant(real):
    """A step that raises the damage of one quadrant's ice by 0.1. (A fault
    that sets a value the same at every step hides: the reference follows
    the call from the program's state, which it has already set.)"""
    def step(self, state, forcing, tinfo, nest=None):
        out, diag, viol = real(self, state, forcing, tinfo, nest)
        ny, nx = out.damage.shape
        damage = out.damage.clone()
        q = (slice(ny // 2, None), slice(nx // 2, None))
        damage[q] = torch.where(out.conc[q] > 0, (damage[q] + 0.1).clamp(max=1.0), damage[q])
        return out.replace(damage=damage), diag, viol
    return step


def test_damage_altered_in_a_region_is_not_correct(rehearse, monkeypatch):
    from nextsim_tpu_torch.model.simulator import Simulator

    monkeypatch.setattr(Simulator, "raw_step_fn", _damage_in_a_quadrant(Simulator.raw_step_fn))
    res = rehearse("arctic_5km.chunk30")
    assert not res["correct"], res["checks"]


def test_a_fault_on_a_quarter_of_a_planes_support_reads_over_its_limit():
    """A plane on 40% of the grid, its values lost in one quadrant (a tenth
    of the grid): the whole grid's 90th percentile would read 0; the
    quantiles over the plane's support read it. Rounding reads under."""
    from benchmark.reference.model import state_gaps

    limits = harness.load_cell("arctic_5km.chunk30")["limits"]
    g = torch.Generator().manual_seed(3)
    ny = nx = 200
    support = torch.zeros(ny, nx, dtype=torch.bool)
    support[40:160, 30:170] = True
    ref = torch.where(support, 0.2 + torch.rand(ny, nx, generator=g, dtype=torch.float64), torch.zeros(()))
    lost = ref.clone()
    lost[100:, 100:] = 0
    rounded = ref.to(torch.float32)
    for program, over in ((lost, True), (rounded, False)):
        gaps = state_gaps({"damage": program}, {"damage": ref})
        for name in ("state_bulk_gap", "state_tail_gap"):
            assert (gaps[name]["damage"] > check.limit_of(limits[name])[0]) == over, (name, gaps[name])


def test_half_the_members_left_out_is_not_correct(rehearse, monkeypatch):
    """The batched step steps the first half of the members and hands the
    rest back unchanged."""
    from nextsim_tpu_torch.model.simulator import Simulator

    real = Simulator.batched_step_fn

    def half(self, states, forcing, tinfo):
        out, diag, viol = real(self, states, forcing, tinfo)
        n = states.conc.shape[0] // 2 or 1
        kept = {name: torch.cat([getattr(out, name)[:n], getattr(states, name)[n:]])
                for name in out.__dataclass_fields__ if getattr(out, name) is not None}
        return out.replace(**kept), diag, viol

    monkeypatch.setattr(Simulator, "batched_step_fn", half)
    assert not rehearse("arctic_10km.ensemble16")["correct"]


def test_forcing_altered_where_it_is_made_is_not_correct(rehearse, monkeypatch):
    from nextsim_tpu_torch.forcing import datasets

    real = datasets.DatasetForcing.__call__

    def call(self, t, t0):
        f = real(self, t, t0)
        return f.replace(tair=f.tair + 0.01)

    monkeypatch.setattr(datasets.DatasetForcing, "__call__", call)
    assert not rehearse("arctic_10km.forecast")["correct"]


def test_reader_modules_import_nothing_of_jax():
    for m in BENCH["per_layer"]:
        importlib.import_module(f"benchmark.metrics.{m['name']}")
    from benchmark import importcheck

    assert importcheck.forbidden(("jax", "jaxlib", "flax", "nextsim_tpu"),
                                 {k: v for k, v in sys.modules.items() if k.startswith("benchmark")}) == []
