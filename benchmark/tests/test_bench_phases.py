"""The phase split (``benchmark/phases.py``) on synthetic traces, and the
new per-layer readers on a traced CPU rehearsal, which has no graph and no
device trace: they report nothing and fail nothing."""

import dataclasses

import pytest

from benchmark import phases, tracing

#: a one-step graph's table: the step's phases over kernels, a memset, two
#: copies and an empty node, which has no device entry
TABLE = [["unattributed", "kernel", 1], ["thermo", "kernel", 2], ["thermo", "memset", 1],
         ["momentum.setup", "memcpy", 1], ["momentum.substeps", "kernel", 2], ["momentum.smoother", "kernel", 1],
         ["transport", "other", 1], ["transport", "kernel", 3], ["transport", "memcpy", 1], ["checks", "kernel", 1]]
NAMES = {"kernel": "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>",
         "memset": "Memset (Unknown)", "memcpy": "memcpy128"}  # as an H100 traces a graph's nodes
SUBSTEP = "void (anonymous namespace)::blocked_substeps<float, 0, 1024, false>"


def _replay(t0):
    """The device entries of one replay from ``t0``: node i takes i + 1 us."""
    out, t = [], t0
    for i, (phase, kind) in enumerate(phases.traced_nodes(TABLE)):
        name = SUBSTEP if phase == "momentum.substeps" else NAMES[kind]
        out.append((name, t, t + (i + 1) * 1e-6))
        t += 1e-5
    return out, t


def _trace(replays=2):
    """Copy-in kernels before each replay and output copies after it, as a
    call issues them."""
    device, t = [], 0.0
    for _ in range(replays):
        device.append(("void at::native::copy_kernel", t, t + 1e-6))
        entries, t = _replay(t + 1e-5)
        device += entries
        device.append(("Memcpy DtoD (Device -> Device)", t, t + 1e-6))
        t += 1e-4
    return tracing.Trace(device=device, host=[], wall_s=t, steps=replays)


def _expected_s():
    out = {}
    for i, (phase, _) in enumerate(phases.traced_nodes(TABLE)):
        out[phase] = out.get(phase, 0.0) + (i + 1) * 1e-6
    return out


@dataclasses.dataclass
class Ctx:
    trace: object
    capture: list


def test_an_aligned_trace_gives_each_phases_sums():
    got = phases.split(_trace(2), [{"phases": TABLE}])
    assert {p: v["s"] for p, v in got.items()} == pytest.approx({p: 2 * s for p, s in _expected_s().items()})
    assert got["momentum.substeps"]["kernels"] == 4 and got["thermo"]["kernels"] == 4
    assert got["momentum.setup"]["kernels"] == 0  # a copy node is none, whatever it runs as
    assert got["transport"]["kernels"] == 6
    ctx = Ctx(_trace(2), [{"phases": TABLE}])
    assert phases.ms_per_step(ctx, ["transport"]) == pytest.approx(1e3 * _expected_s()["transport"])
    assert phases.ms_per_step(ctx, ["momentum.setup", "momentum.smoother"]) == pytest.approx(
        1e3 * (_expected_s()["momentum.setup"] + _expected_s()["momentum.smoother"]))
    assert phases.ms_per_step(ctx, ["fsd"]) is None  # a phase the graph does not run


def test_a_graph_without_a_table_or_a_trace_without_its_kernel_reads_nothing():
    assert phases.split(_trace(1), [{"phases": None}]) is None
    assert phases.split(_trace(1), [{}]) is None
    no_substeps = [r for r in TABLE if r[0] != "momentum.substeps"]
    assert phases.split(_trace(1), [{"phases": no_substeps}]) is None
    assert phases.ms_per_step(Ctx(None, [{"phases": TABLE}]), ["thermo"]) is None
    assert phases.ms_per_step(Ctx(_trace(1), []), ["thermo"]) is None


@pytest.mark.parametrize("fault", ["an entry missing", "an entry more", "a kernel for the memset",
                                   "a memset for a kernel", "a copy for a kernel", "a kernel for a copy",
                                   "a substep kernel outside a replay"])
def test_a_trace_that_does_not_align_reads_nothing(fault):
    trace = _trace(2)
    device = list(trace.device)
    first = next(i for i, e in enumerate(device) if e[0] == NAMES["memset"])
    substep = next(i for i, e in enumerate(device) if e[0] == SUBSTEP)
    if fault == "an entry missing":  # the table then lies one entry off from the substep kernel back
        del device[substep - 1]
    elif fault == "an entry more":
        device.insert(substep, (NAMES["kernel"], device[substep][1] - 1e-7, device[substep][1] - 5e-8))
    elif fault == "a kernel for the memset":
        device[first] = (NAMES["kernel"],) + device[first][1:]
    elif fault == "a memset for a kernel":
        device[first - 1] = (NAMES["memset"],) + device[first - 1][1:]
    elif fault == "a copy for a kernel":
        device[first - 1] = ("memcpy32_post",) + device[first - 1][1:]
    elif fault == "a kernel for a copy":
        device[first + 1] = (NAMES["kernel"],) + device[first + 1][1:]
    else:
        device.append((SUBSTEP, 1.0, 1.001))
    assert phases.split(dataclasses.replace(trace, device=device), [{"phases": TABLE}]) is None


def test_the_entries_order_is_their_start():
    trace = _trace(2)
    shuffled = dataclasses.replace(trace, device=list(reversed(trace.device)))
    assert phases.split(shuffled, [{"phases": TABLE}]) == phases.split(trace, [{"phases": TABLE}])


NEW = ["thermo_device_ms_per_step", "momentum_device_ms_per_step", "transport_device_ms_per_step", "warmup_s"]


def test_a_traced_cpu_rehearsal_reports_none_of_the_new_metrics(rehearse):
    res = rehearse("arctic_5km.chunk30", trace=True)
    assert "init_s" in res["metrics"]
    assert not set(NEW) & set(res["metrics"])
    assert res["correct"], res["checks"]
