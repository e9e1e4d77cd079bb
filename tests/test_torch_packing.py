"""The port's grid packing against the reference's.

Built with the same arguments, the port's and ``repro``'s scenario
grids must pack to identical structure arrays, identical per-point
parameter arrays (same keys, dtypes and values) and identical ring
horizons — the engines then start from the same numbers.
``FabricSweepParams.from_arrays`` must round-trip the reference's
packing, dense or sparse.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fabric import scenarios as SC
from repro.fabric.vector import FabricSweepParams as RefParams
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric.vector import FabricSweepParams

torch.set_num_threads(1)

_FIELDS = [f.name for f in dataclasses.fields(FabricSweepParams)]


def _bench_grid(M):
    """The 48-point, 8-sender incast grid of the fabric bench, 20 ms."""
    bursts = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
    scens, _ = M.fabric_grid(
        lambda mode, pfc, burst_mb: M.incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=0.02),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=bursts)
    return scens


def _small_grid(M):
    return M.incast_grid(burst_mb=(0.5, 2.0), n_senders=4,
                         sim_time_s=0.001)[0]


def _tweaked_grid(M):
    """Knobs off the defaults: legacy single-TC switches, CNP propagation
    delays (a per-flow override and the fabric scalar), open-loop caps,
    late starts and burst trains, no victim flow."""
    scens = [M.incast(3, mode=m, burst_mb=1.0, pfc=p, with_victim=False,
                      sim_time_s=0.0005)
             for m in ("jet", "ddio") for p in (False, True)]
    for i, s in enumerate(scens):
        s.fabric.switch.per_tc = i % 2 == 0
        s.fabric.cnp_delay_us = 2.0 * i
        s.flows[0].cnp_delay_us = 5.0
        s.flows[1].offered_gbps = 50.0 + i
        s.flows[1].start_us = 10.0 * i
        s.flows[2].on_off_us = (20.0, 5.0 + i)
    return scens


GRIDS = {"bench48": _bench_grid, "small": _small_grid,
         "tweaked": _tweaked_grid}


def _assert_same(port, ref):
    for name in _FIELDS:
        a, b = getattr(port, name), getattr(ref, name)
        if name == "pvals":
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_packing_matches_reference(grid):
    port = FabricSweepParams.from_scenarios(GRIDS[grid](TSC))
    ref = RefParams.from_scenarios(GRIDS[grid](SC))
    _assert_same(port, ref)


def test_bench_grid_shape():
    fsp = FabricSweepParams.from_scenarios(_bench_grid(TSC))
    assert (fsp.n_points, fsp.n_flows, fsp.n_ports, fsp.n_recv) \
        == (48, 9, 14, 2)
    assert (fsp.ticks, fsp.ring_len, fsp.cnp_ring) == (20000, 1215, 1)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_from_arrays_round_trips_reference_packing(grid):
    ref = RefParams.from_scenarios(GRIDS[grid](SC))
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    port = FabricSweepParams.from_arrays(d)
    _assert_same(port, ref)
    _assert_same(port, FabricSweepParams.from_scenarios(GRIDS[grid](TSC)))


def _pod_grid(M, fail: bool):
    scens = M.pod_incast_grid(mode=("jet",), pfc=(False, True),
                              sim_time_s=0.0003)[0]
    if fail:
        # a link down mid-run: the sparse engine carries the window as
        # per-tick link state (``pack_fail``)
        for s in scens:
            s.topology.fail_link("p1s0", "ss0", at_us=100.0)
    return scens


@pytest.mark.parametrize("fail", [True, False], ids=["dynamic", "sparse"])
def test_from_arrays_refuses_dynamic_and_sparse_packings(fail):
    """The reference's sparse packings (with a failure window: the
    ``pack_fail`` one) go through ``from_arrays``, equal the port's own
    packing, and run equal to the reference's ``numpy`` backend."""
    from repro.fabric.vector import run_fabric_sweep as ref_sweep
    from repro_torch.fabric.vector import run_packed
    ref = RefParams.from_scenarios(_pod_grid(SC, fail), sparse=True)
    assert ref.sparse and ref.pack_fail == fail
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    port = FabricSweepParams.from_arrays(d)
    _assert_same(port, ref)
    _assert_same(port, FabricSweepParams.from_scenarios(_pod_grid(TSC, fail),
                                                        sparse=True))
    got = run_packed(port, device="cpu", dtype=torch.float64)
    want = ref_sweep(_pod_grid(SC, fail), backend="numpy")
    for k in want:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=1e-9, atol=0.0), k


def test_from_arrays_refuses_unknown_and_missing_fields():
    ref = RefParams.from_scenarios(_small_grid(SC))
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    with pytest.raises(ValueError, match="unknown"):
        FabricSweepParams.from_arrays(dict(d, extra=1))
    d.pop("occ")
    with pytest.raises(ValueError, match="lacks"):
        FabricSweepParams.from_arrays(d)
