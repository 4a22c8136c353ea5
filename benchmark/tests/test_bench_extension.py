"""A cell of a path that the harness does not run yet brings its pieces as
new files, and no file that is there is edited: ``check.run`` takes the
reference from the driver module's ``reference``, ``inputs.ensure`` writes a
dataset with ``inputs/<name>.py``, and a per-layer reader gets the run's
options and the change in the driver's counters. Without such files the
harness is as it was: ``Reference`` refuses the paths it does not run."""

import datetime
import importlib
import sys

import pytest

from benchmark import check, drivers, harness, inputs, metrics
from benchmark.tests import conftest

SEED = 2**31 + 20231

#: a chunks driver whose module brings its own reference: the plain one,
#: recording each call it follows
OWN_REFERENCE = '''
from benchmark.drivers.chunks import Driver as Chunks, compare, steps_a_call_bound
from benchmark.reference.model import Reference

FOLLOWED = []


class Driver(Chunks):
    def result(self):
        return dict(super().result(), kind=__name__.rsplit(".", 1)[1])


class Own(Reference):
    def follow(self, state, pcpt, k):
        FOLLOWED.append((pcpt, k))
        return super().follow(state, pcpt, k)


def reference(options, device):
    return Own(options, device)
'''

#: a chunks driver that counts its calls and their steps
COUNTING = '''
from benchmark.drivers.chunks import Driver as Chunks, compare, steps_a_call_bound


class Driver(Chunks):
    calls = 0

    def call(self):
        self.calls += 1
        return super().call()

    def counters(self):
        return {"calls": self.calls, "steps": self.calls * self.k}

    def result(self):
        return dict(super().result(), kind=__name__.rsplit(".", 1)[1])
'''

#: a reader of a counter and an option, keeping each ctx it was given
READER = '''
SEEN = []


def read(ctx):
    SEEN.append(ctx)
    if "steps" not in ctx.counters:
        return None
    return ctx.counters["steps"] * float(ctx.options["simul.timestep"])
'''

#: a dataset writer of its own
WRITER = '''
def write(d, first_day, days):
    (d / f"waves_{first_day:%Y%m%d}.bin").write_bytes(bytes(range(days)))
'''


@pytest.fixture
def new_file(tmp_path, monkeypatch):
    """add(package, name, source): the module ``<package>.<name>`` from a
    new file in a directory of its own, as a later PR would add it."""
    added = []

    def add(package, name, source):
        d = tmp_path / package.__name__.replace(".", "_")
        d.mkdir(exist_ok=True)
        (d / f"{name}.py").write_text(source)
        monkeypatch.setattr(package, "__path__", list(package.__path__) + [str(d)])
        added.append(f"{package.__name__}.{name}")
        return importlib.import_module(added[-1])

    yield add
    for name in added:
        sys.modules.pop(name, None)


def _rehearse(tmp_path, driver, trace=False, per_layer=()):
    """A CPU rehearsal of arctic_5km.chunk30 (48 x 48, two calls of 3 steps)
    through the driver module ``driver``."""
    spec = conftest.small_spec("arctic_5km.chunk30", harness.ROOT / "BENCHMARK.json")
    spec["traffic"]["driver"] = driver
    spec["per_layer"] = list(per_layer)
    extra = dict(conftest.SMALL, **{"grid.resolution": conftest.RESOLUTION["arctic_5km"]})
    return harness.run_cell(spec, SEED, 1.0, trace, device="cpu", calls=2, cache=tmp_path / "cache",
                            extra_options=extra, log=lambda m: None)


def test_a_drivers_own_reference_is_the_one_check_uses(new_file, tmp_path):
    own = new_file(drivers, "ext_own_reference", OWN_REFERENCE)
    plain = _rehearse(tmp_path, "chunks")
    res = _rehearse(tmp_path, "ext_own_reference")
    assert own.FOLLOWED == [(6, 3)]  # the last call: after the warm call and one more, 3 steps
    assert res["checks"] == plain["checks"] and res["correct"], res["checks"]


@pytest.mark.parametrize("override", [
    {"nextwim.use_wim": True},
    {"wave_coupling.num_fsd_bins": 20},
    {"coupler.with_waves": True},
    {"nesting.use_nesting": True},
    {"setup.ocean-type": "coupled"},
], ids=lambda o: next(iter(o)))
def test_without_a_reference_of_its_own_the_check_refuses_what_reference_does_not_run(override, tmp_path):
    """The chunks driver brings no reference, so ``Reference`` checks it,
    and refuses the waves, the floe sizes, a coupler and nesting."""
    assert not hasattr(drivers.load("chunks"), "reference")
    opts = harness.run_options(harness.load_cell("arctic_5km.chunk30"), SEED, tmp_path)
    opts.update(conftest.SMALL, **override)
    with pytest.raises(NotImplementedError):
        check.run({"kind": "chunks"}, opts, {}, "cpu")


def test_a_new_dataset_is_written_by_its_own_file(new_file, tmp_path, monkeypatch):
    """``inputs/<name>.py`` writes a dataset that ``WRITERS`` does not
    name; today's sets go to their writers under the keys they had."""
    new_file(inputs, "ext_waves", WRITER)
    written = []
    for name in inputs.WRITERS:
        monkeypatch.setitem(inputs.WRITERS, name, lambda d, day, days, name=name: written.append((name, day, days)))
    monkeypatch.setattr(inputs, "write_etopo", lambda d: written.append(("etopo",)))
    day = datetime.datetime(2015, 10, 16)

    got = inputs.ensure(tmp_path, ["topaz4_rean", "ext_waves", "era5", "etopo"], day, 3)
    assert got["dir"].name == "era5_etopo_ext_waves_topaz4_rean_20151016_3d_topaz800x880"
    assert (got["dir"] / "waves_20151016.bin").read_bytes() == bytes(range(3))
    assert got["bytes_written"] == 3
    assert written == [("era5", day, 3), ("etopo",), ("topaz4_rean", day, 3)]
    assert inputs.ensure(tmp_path, ["ext_waves", "era5", "etopo", "topaz4_rean"], day, 3)["bytes_written"] == 0

    for sets, key in ((["era5", "topaz4_rean", "etopo"], "era5_etopo_topaz4_rean_20151016_4d_topaz800x880"),
                      (["era5"], "era5_20151016_4d_topaz800x880"),
                      (["topaz4_rean"], "topaz4_rean_20151016_4d_topaz800x880"),
                      (["etopo"], "etopo_20151016_4d_topaz800x880")):
        assert inputs.ensure(tmp_path, sets, day, 4)["dir"].name == key
    assert len(written) == 3 + 3 + 1 + 1 + 1


def test_a_reader_gets_the_options_and_the_counters_over_its_stretch(new_file, tmp_path):
    """Two window calls of 3 steps after the warm call and the traced one:
    the counters' change is theirs alone. A driver with no ``counters()``
    gives {}."""
    new_file(drivers, "ext_counting", COUNTING)
    reader = new_file(metrics, "ext_seconds_counted", READER)
    entry = {"name": "ext_seconds_counted", "unit": "s", "better": "lower", "source": "program_counter",
             "layer": "step program", "moves": "model_days_per_hour", "workloads": ["arctic_5km.chunk30"]}

    res = _rehearse(tmp_path, "ext_counting", trace=True, per_layer=[entry])
    ctx = reader.SEEN[-1]
    assert ctx.counters == {"calls": 2, "steps": 6} and ctx.steps == 6
    assert ctx.options["grid.nx"] == 48 and ctx.options["simul.timestep"] == 200
    with pytest.raises(TypeError):
        ctx.options["simul.timestep"] = 100
    assert res["metrics"]["ext_seconds_counted"] == {"value": 1200.0, "unit": "s"}
    assert res["correct"], res["checks"]

    res = _rehearse(tmp_path, "chunks", trace=True, per_layer=[entry])
    assert reader.SEEN[-1].counters == {} and reader.SEEN[-1].options["grid.nx"] == 48
    assert "ext_seconds_counted" not in res["metrics"]
