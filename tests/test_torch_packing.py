"""The port's grid packing against the reference's.

Built with the same arguments, the port's and ``repro``'s scenario
grids must pack to identical structure arrays, identical per-point
parameter arrays (same keys, dtypes and values) and identical ring
horizons — the engines then start from the same numbers.
``FabricSweepParams.from_arrays`` must round-trip the reference's
packing and refuse the layers the port does not run.
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


def _dyn_packing():
    """A pod fabric whose link fails mid-run: the sparse engine carries
    the failure window as per-tick link state (``pack_fail``), which the
    port does not run (a dense dynamic grid with the message layer packs:
    ``tests/test_torch_messages.py``)."""
    scens = SC.pod_incast_grid(mode=("jet",), pfc=(False,),
                               sim_time_s=0.0005)[0]
    for s in scens:
        s.topology.fail_link("p1s0", "ss0", at_us=100.0)
    ref = RefParams.from_scenarios(scens, sparse=True)
    assert ref.pack_fail
    return ref


def _sparse_packing():
    return RefParams.from_scenarios(
        SC.pod_incast_grid(mode=("jet",), pfc=(False,),
                           sim_time_s=0.0005)[0], sparse=True)


@pytest.mark.parametrize("make", [_dyn_packing, _sparse_packing],
                         ids=["dynamic", "sparse"])
def test_from_arrays_refuses_dynamic_and_sparse_packings(make):
    ref = make()
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    with pytest.raises(NotImplementedError):
        FabricSweepParams.from_arrays(d)


def test_from_arrays_refuses_unknown_and_missing_fields():
    ref = RefParams.from_scenarios(_small_grid(SC))
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    with pytest.raises(ValueError, match="unknown"):
        FabricSweepParams.from_arrays(dict(d, extra=1))
    d.pop("occ")
    with pytest.raises(ValueError, match="lacks"):
        FabricSweepParams.from_arrays(d)
