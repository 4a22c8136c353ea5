"""The frozen yardstick of the substep kernel, pinned to PERF.md's numbers."""

import pytest

from benchmark import bounds


@pytest.mark.parametrize("n, bound_ms", [(464, 0.0738), (1216, 0.5062)])
def test_kernel_bound_float32(n, bound_ms):
    ms, binds, _, _ = bounds.kernel_bound_ms(n, n, 120, "float32", "bbm")
    assert round(ms, 4) == bound_ms
    assert binds == "operations"


@pytest.mark.parametrize("n, ops", [(608, 8.486e9), (1216, 3.392e10)])
def test_substep_ops_a_step(n, ops):
    assert round(bounds.substep_ops(n, n, 120, "bbm"), -6) == pytest.approx(ops, rel=1e-4)


def test_members_scale_operations_not_shared_bytes():
    one = bounds.kernel_bound_ms(608, 608, 120, "float32", "bbm")
    sixteen = bounds.kernel_bound_ms(608, 608, 120, "float32", "bbm", members=16)
    assert sixteen[3] == pytest.approx(16 * one[3])
    assert bounds.substep_ops(608, 608, 120, "bbm", members=16) == 16 * bounds.substep_ops(608, 608, 120, "bbm")


def test_bytes_bound_counts_each_plane_once():
    """30 planes read on a tile and 8 state planes written (bbm), 4 bytes
    each, nodes (ny+1)(nx+1) for velocities and node planes."""
    n = 1216
    cells, nodes = n * n, (n + 1) * (n + 1)
    node_planes = 4 + 17 - 2  # vt/ut, and _NODE less vtm_u/vtm_v
    expected = 4 * ((node_planes * nodes + (30 - node_planes) * cells) + (4 * nodes + 4 * cells))
    _, _, bytes_ms, _ = bounds.kernel_bound_ms(n, n, 120, "float32", "bbm")
    assert bytes_ms == pytest.approx(1e3 * expected / bounds.H100_BYTES_PER_S)
