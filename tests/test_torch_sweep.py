"""The port's receiver-datapath sweep engine against the reference's.

Both packages build the grid from the same arguments.  The reference's
``run_sweep`` is float32 in both of its backends, so the port's CPU run
must equal its ``numpy`` backend on every output, bit for bit, and its
``jax`` backend wherever the reference's two backends agree with each
other.  Two grids: a 2 x 2 x 2 slice of the fabric bench's sweep axes
(msg_bytes x cpu_membw x DDIO) in both receiver modes, and a Jet grid
under escape pressure (small pools, heavy stragglers, no memory-escape
budget at some points), so that replaces, copies, escape ECN and CNPs
all fire.  Under escape pressure the reference's ``jax`` backend moves
``escape_dram_gbps`` by ~8e-8 relative from its ``numpy`` backend (XLA
fuses ``esc_dram + 0.1 * x_rep``); there the port equals ``numpy`` and
is held to ``jax`` within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import simulator as S
from repro.fabric import sweep as RS
from repro_torch.core import simulator as TS
from repro_torch.fabric import sweep as TW

torch.set_num_threads(1)

OUTPUTS = ["goodput_gbps", "cnp_count", "escape_ecn", "escape_replaces",
           "escape_copies", "ddio_miss_rate", "pool_peak_bytes",
           "pool_avg_bytes", "pfc_pause_us", "dropped_bytes",
           "nic_dram_gbps", "escape_dram_gbps"]


def _bench_slice(sim, grid_configs, mode):
    """2 x 2 x 2 of ``benchmarks/bench_fabric.py``'s sweep axes."""
    return grid_configs(sim.testbed_100g, mode=mode, sim_time_s=0.002,
                        msg_bytes=[64 << 10, 1 << 20],
                        cpu_membw_gbps=[1200.0, 1900.0],
                        ddio_bytes=[4 << 20, 6 << 20])[0]


def _escape(sim, grid_configs, mode):
    return grid_configs(sim.testbed_100g, mode=mode, sim_time_s=0.002,
                        jet_pool_bytes=[2 << 20, 12 << 20],
                        straggler_frac=[0.05, 0.3],
                        mem_esc_bytes=[0, 2 << 20])[0]


GRIDS = {"bench_ddio": (_bench_slice, "ddio"),
         "bench_jet": (_bench_slice, "jet"),
         "escape_jet": (_escape, "jet")}


def _configs(pkg, grid):
    make, mode = GRIDS[grid]
    if pkg == "ref":
        return make(S, RS.grid_configs, mode)
    return make(TS, TW.grid_configs, mode)


_RUNS = {}


def _run(kind, grid):
    key = (kind, grid)
    if key not in _RUNS:
        if kind == "port":
            _RUNS[key] = TW.run_sweep(_configs("port", grid), device="cpu")
        else:
            _RUNS[key] = RS.run_sweep(_configs("ref", grid), backend=kind)
    return _RUNS[key]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_packing_matches_reference(grid):
    ref = RS.SweepParams.from_configs(_configs("ref", grid))
    port = TW.SweepParams.from_configs(_configs("port", grid))
    assert sorted(port.vals) == sorted(ref.vals)
    for k in ref.vals:
        assert port.vals[k].dtype == ref.vals[k].dtype == np.float32, k
        assert np.array_equal(port.vals[k], ref.vals[k]), k
    for k in ("d_base", "d_strag"):
        a, b = getattr(port, k), getattr(ref, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("n_points", "ticks", "dt_us", "ring_len"):
        assert getattr(port, k) == getattr(ref, k), k


@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_cpu_run_is_bitwise_the_reference(grid, backend):
    got, want = _run("port", grid), _run(backend, grid)
    numpy = _run("numpy", grid)
    assert sorted(got) == sorted(want) == sorted(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == want[k].dtype, k
        if np.array_equal(numpy[k], _run("jax", grid)[k]):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert grid == "escape_jet" and k == "escape_dram_gbps", k
            assert np.array_equal(got[k], numpy[k]), k
            assert np.allclose(got[k], want[k], rtol=1e-6, atol=0.0), k


def test_escape_grid_fires_every_ladder_rung():
    """The escape grid is not vacuous: replaces, copies, escape ECN and
    CNPs all fire somewhere, and some points lose goodput to them."""
    r = _run("numpy", "escape_jet")
    for k in ("escape_replaces", "escape_copies", "escape_ecn",
              "cnp_count"):
        assert r[k].max() > 0, k
    assert r["goodput_gbps"].min() < 0.5 * r["goodput_gbps"].max()


def test_from_configs_errors():
    with pytest.raises(ValueError, match="empty"):
        TW.SweepParams.from_configs([])
    with pytest.raises(ValueError, match="share dt"):
        TW.SweepParams.from_configs(
            [TS.testbed_100g("jet", sim_time_s=0.004),
             TS.testbed_100g("jet", sim_time_s=0.008)])
    with pytest.raises(ValueError, match="share dt"):
        TW.SweepParams.from_configs(
            [TS.testbed_100g("jet", sim_time_s=0.004),
             TS.testbed_100g("jet", sim_time_s=0.004, dt_us=2.0)])
    with pytest.raises(ValueError, match="cpu_membw_schedule"):
        TW.SweepParams.from_configs(
            [TS.testbed_100g("ddio", sim_time_s=0.001,
                             cpu_membw_schedule=lambda t: 1000.0)])


def test_grid_configs_order_matches_reference():
    axes = dict(ddio_bytes=[4 << 20, 6 << 20], msg_bytes=[64 << 10],
                cpu_membw_gbps=[1200.0, 1900.0])
    _, pa = RS.grid_configs(S.testbed_100g, mode="jet", **axes)
    ca, pb = TW.grid_configs(TS.testbed_100g, mode="jet", **axes)
    assert pa == pb
    assert all(c.mode == "jet" and c.sim_time_s == 0.01 for c in ca)
    assert [dataclasses.astuple(c)[:4] for c in ca] == \
        [dataclasses.astuple(c)[:4]
         for c in RS.grid_configs(S.testbed_100g, mode="jet", **axes)[0]]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.run_sweep(_configs("port", "bench_jet"))
