"""The step's phases (``utils.timer.phase``) and the Timer's profiler
ranges, on the CPU.

Eagerly a phase is a ``record_function`` range while a profiler runs: a
chunk of an arctic slice with thermodynamics on, under ``torch.profiler``,
has each phase of the step once a step in the step's order, and at least
99% of the aten operators the step program dispatches lie inside one. With
no profiler running, neither a phase nor a Timer node opens a range. The
phases of the paths that run them appear there: ``fsd`` (the floe-size
distribution), ``nesting`` (a nested free-drift run, whose velocity is the
``momentum.smoother`` phase), ``perturb`` (a perturbed member's chunk and
the batched ensemble's draws). ``chain_table`` turns a capture's marks into
the phase table the card's graphs carry (tests/test_torch_cuda.py holds it
to real graphs and traces); ``Simulator.run`` writes the tables beside its
trace.
"""

import json

import pytest
import torch

from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble
from nextsim_tpu_torch.model import captured
from nextsim_tpu_torch.utils import timer
from test_torch_ensemble import ENS, _pert_sim
from test_torch_nesting import nested_config, write_nesting_files
from test_torch_simulator import SLICES

torch.set_num_threads(1)

PHASES = ("perturb", "thermo", "fsd", "momentum.setup", "momentum.substeps", "momentum.smoother", "transport",
          "nesting", "checks", "sums")
#: the phases of a bbm step with thermodynamics on, in order
STEP = ["thermo", "momentum.setup", "momentum.substeps", "momentum.smoother", "transport", "checks", "sums"]
ARCTIC = dict(SLICES["arctic32_thermo"], **{"dynamics.substeps": 20})


def _profiled(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return sorted(prof.events(), key=lambda e: e.time_range.start)


def _phases(events):
    return [e.name for e in events if e.name in PHASES]


def _ancestors(e):
    e = e.cpu_parent
    while e is not None:
        yield e
        e = e.cpu_parent


def test_eager_chunk_has_each_phase_once_a_step_in_order():
    sim = Simulator(Config(overrides=ARCTIC), device="cpu")
    events = _profiled(lambda: sim.step_chunk(2))
    assert _phases(events) == STEP * 2
    # the Timer's nodes are ranges on the same clock
    names = {e.name for e in events}
    assert {"step", "forcing", "enqueue", "outputs"} <= names


def test_phases_hold_the_step_programs_aten_ops():
    sim = Simulator(Config(overrides=ARCTIC), device="cpu")
    events = _profiled(lambda: sim.step_chunk(2))
    enqueue = [e for e in events if e.name == "enqueue"]
    assert len(enqueue) == 1
    ops = [e for e in events if e.name.startswith("aten::")
           and not any(a.name.startswith("aten::") for a in _ancestors(e))
           and any(a is enqueue[0] for a in _ancestors(e))]
    inside = [e for e in ops if any(a.name in PHASES for a in _ancestors(e))]
    assert len(ops) > 1000 and len(inside) >= 0.99 * len(ops), (len(inside), len(ops))


def test_no_range_opens_without_a_profiler(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"a range {name!r} opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert timer.phase("thermo") is timer.phase("transport")  # one shared null context
    sim = Simulator(Config(overrides=ARCTIC), device="cpu")
    sim.step_chunk(2)
    sim.step()
    assert sim.pcpt == 3


def _fsd():
    return Simulator(Config(overrides=dict(SLICES["toy_square32_thermo"], **{
        "wave_coupling.num_fsd_bins": 6, "thermo.melt_type": 3, "dynamics.substeps": 10})), device="cpu")


def _nested(tmp_path):
    write_nesting_files(str(tmp_path))
    return Simulator(Config(overrides=nested_config(tmp_path)), device="cpu")


@pytest.mark.parametrize("path, expected", [
    ("fsd", ["thermo", "fsd", "momentum.setup", "momentum.substeps", "momentum.smoother", "transport", "checks",
             "sums"]),
    ("nesting", ["thermo", "momentum.smoother", "transport", "nesting", "checks", "sums"]),
    ("perturb", ["perturb"] + STEP),
    ("batched perturb", ["perturb"] + STEP[:-1]),
])
def test_the_paths_phases_appear_once_a_step(path, expected, tmp_path):
    if path == "fsd":
        run = _fsd().step_chunk
    elif path == "nesting":
        run = _nested(tmp_path).step_chunk
    elif path == "perturb":
        run = _pert_sim().step_chunk
    else:
        ens = BatchedEnsemble(Config(overrides=dict(ENS, **{"dynamics.substeps": 10})), 2, device="cpu")
        run = lambda k: [ens.step() for _ in range(k)]  # noqa: E731
    assert _phases(_profiled(lambda: run(2))) == expected * 2


# --- the phase table of a capture's marks ----------------------------------

NODES = [11, 12, 13, 14, 15, 16]  # in the order libcuda lists them
CHAIN = [()] + [(n,) for n in NODES[:-1]]
KINDS = ["kernel", "kernel", "memset", "kernel", "other", "memcpy"]


def test_chain_table_follows_the_chain_and_the_marks():
    marks = [((), "thermo"), ((11,), timer.UNATTRIBUTED), ((12,), "transport"), ((12,), "checks"),
             ((15,), timer.UNATTRIBUTED)]
    table, why = captured.chain_table(NODES, CHAIN, KINDS, marks)
    assert why is None
    assert table == [["thermo", "kernel", 1], ["unattributed", "kernel", 1], ["checks", "memset", 1],
                     ["checks", "kernel", 1], ["checks", "other", 1], ["unattributed", "memcpy", 1]]
    assert sum(r[2] for r in table) == len(NODES)
    assert captured.chain_table(NODES, CHAIN, KINDS, [])[0] == [
        ["unattributed", "kernel", 2], ["unattributed", "memset", 1], ["unattributed", "kernel", 1],
        ["unattributed", "other", 1], ["unattributed", "memcpy", 1]]
    assert captured.chain_table([], [], [], []) == ([], None)


@pytest.mark.parametrize("case", ["fork", "join", "two roots", "listed out of order", "wide mark", "foreign tail",
                                  "late empty mark"])
def test_chain_table_refuses_what_is_no_chain(case):
    nodes, deps, marks = list(NODES), list(CHAIN), [((), "thermo"), ((12,), "transport")]
    if case == "fork":
        deps[3] = (12,)  # 12 -> 13 and 12 -> 14
    elif case == "join":
        deps[3] = (12, 13)
    elif case == "two roots":
        deps[3] = ()
    elif case == "listed out of order":
        nodes[2], nodes[3] = nodes[3], nodes[2]
    elif case == "wide mark":
        marks = [((11, 12), "transport")]
    elif case == "foreign tail":
        marks = [((99,), "transport")]
    else:
        marks = [((12,), "transport"), ((), "checks")]
    table, why = captured.chain_table(nodes, deps, KINDS, marks)
    assert table is None and why


def test_profile_export_writes_the_phase_tables(tmp_path):
    over = dict(SLICES["toy_square32"], **{"dynamics.substeps": 20, "simul.duration": 2 * 200 / 86400.0,
                                           "debugging.profile_dir": str(tmp_path / "prof"),
                                           "output.exporter_path": str(tmp_path / "out")})
    sim = Simulator(Config(overrides=over), device="cpu")
    sim.run()
    prof = tmp_path / "prof"
    assert (prof / "trace.json").exists()
    # the CPU captures no graph: an empty list
    assert json.loads((prof / "phases.json").read_text()) == []
    names = {e.get("name") for e in json.loads((prof / "trace.json").read_text())["traceEvents"]}
    assert {"step", "enqueue", "momentum.substeps", "transport", "checks"} <= names
