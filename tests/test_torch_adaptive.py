"""The port's adaptive dt (``AdaptiveConfig``, ``make_stride_fn``,
``macro_advance``) against the reference's, on the CPU.

* float64: ``run_fabric_sweep(adaptive_dt=True)`` equals the reference's
  ``backend="numpy"`` adaptive run (<= 1e-9 relative, finite masks and
  ``adaptive_iterations`` equal) on the reference's adaptive grid
  (``tests/test_fused.py:_incast_grid``, 4 senders, 2 ms) with and
  without its victim, and on 1 ms grids through the dynamic-routing,
  message and fault branches of the stride;
* the stride and the macro advance equal the reference's on the same
  pairs of states, taken along a fine run;
* float32: within ``rel_bytes_bound + 5e-4`` of the reference's fine
  numpy run (its ``test_adaptive_jax_within_bound``);
* the iteration the card captures and the CPU runs (always
  macro-advance) equals the reference's host loop (macro advance skipped
  at k == 1);
* on/off trains keep every tick fine and equal fixed dt; ``max_stride=1``
  equals fixed dt element for element; a sparse (3-level) grid raises.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.fabric import fused as RF
from repro.fabric import scenarios as SC
from repro.fabric import vector as RV
from repro.fabric.faults import FaultConfig as RFaultConfig
from repro.fabric.topology import make_pod_clos
from repro_torch.fabric import fused
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric import vector as TV
from repro_torch.fabric.faults import FaultConfig as TFaultConfig
from repro_torch.fabric.vector import (FabricRun, FabricSweepParams,
                                       run_fabric_sweep, run_packed)

torch.set_num_threads(1)

def _incast_grid(M, sim_s=0.002, burst_mb=0.5, n=4, with_victim=True):
    """``tests/test_fused.py:_incast_grid`` from either package."""
    return [M.incast(n, mode=m, burst_mb=burst_mb, sim_time_s=sim_s,
                     pfc=p, with_victim=with_victim)
            for m in ("jet", "ddio") for p in (False, True)]


def _routing(M, F):
    return M.routing_grid(modes=("weighted_ecmp", "adaptive"),
                          fail_at_us=(math.inf, 150.0), burst_mb=0.5,
                          n_senders=4, sim_time_s=0.001)[0]


def _messages(M, F):
    return M.message_sweep_grid(msg_kb=(16.0,), window=(4,),
                                verb=("write",), algo=("dcqcn", "hpcc"),
                                n_senders=4, sim_time_s=0.001)[0]


def _faults(M, F):
    out = M.lossy_incast_grid(loss_rate=(0.0, 0.01),
                              recovery=("selective",), n_senders=4,
                              sim_time_s=0.001)[0]
    crash = M.lossy_incast(n_senders=4, loss_rate=0.0,
                           recovery="selective", sim_time_s=0.001)
    crash.fabric.faults = F(0.0, seed=7).crash("h1_0", 100.0, 200.0)
    return out + [crash]


GRIDS = {"incast_victim": lambda M, F: _incast_grid(M),
         "incast_no_victim": lambda M, F: _incast_grid(M,
                                                       with_victim=False),
         "routing": _routing, "messages": _messages, "faults": _faults}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return math.inf
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


@pytest.mark.parametrize("grid", GRIDS)
def test_float64_adaptive_equals_reference_numpy(grid):
    want = RV.run_fabric_sweep(GRIDS[grid](SC, RFaultConfig),
                               backend="numpy", adaptive_dt=True)
    got = run_fabric_sweep(GRIDS[grid](TSC, TFaultConfig), device="cpu",
                           dtype=torch.float64, adaptive_dt=True)
    assert np.array_equal(got["adaptive_iterations"],
                          want["adaptive_iterations"])
    assert sorted(got) == sorted(want)
    for k in want:
        if np.asarray(want[k]).dtype.kind in "fiu":
            assert _rel(got[k], want[k]) <= 1e-9, k
        else:
            assert np.array_equal(got[k], want[k]), k


def test_adaptive_grid_coarsens():
    """The victimless grid drains and goes quiet: well under half the
    ticks are iterations (the reference's own claim)."""
    fsp = FabricSweepParams.from_scenarios(
        _incast_grid(TSC, with_victim=False))
    run = FabricRun(fsp, device="cpu", dtype=torch.float64,
                    adaptive=fused.AdaptiveConfig())
    run.run()
    assert run.iterations < 0.5 * fsp.ticks
    assert run.batches < 150 and int(run.t) == fsp.ticks


def _reference_pairs(scens, picks):
    """(reference packing, reference params, [(t, s, s1)]) along the
    reference's fine numpy run, at the ticks ``picks``."""
    fsp = RV.FabricSweepParams.from_scenarios(scens)
    p = RV._np_params(fsp, np.float64)
    st = RV._static(fsp, np, np.float64)

    def ring_set(ring, idx, v):
        ring[..., idx, :, :] = v
        return ring

    step = RV._make_step(np, ring_set, st, p, fsp.dt_us, fsp.ring_len,
                         np.float64, fsp.cnp_ring, RV._opts(fsp))
    s = RV._init_state(np, (fsp.n_points,), fsp, p, np.float64)
    pairs = []
    for t in range(max(picks) + 1):
        s1 = step(s, np.int32(t), np.int32(t))
        if t in picks:
            snap = {k: np.array(v) for k, v in s.items()}
            pairs.append((t, snap, {k: np.array(v) for k, v in s1.items()}))
        s = s1
    return fsp, pairs


@pytest.mark.parametrize("grid", ["incast_no_victim", "routing",
                                  "messages", "faults"])
def test_stride_and_macro_advance_equal_reference(grid):
    picks = set(range(0, 1000, 37)) | {999}
    ref_fsp, pairs = _reference_pairs(GRIDS[grid](SC, RFaultConfig),
                                      picks)
    d = {f.name: getattr(ref_fsp, f.name)
         for f in dataclasses.fields(ref_fsp)}
    fsp = FabricSweepParams.from_arrays(d)
    cfg = fused.AdaptiveConfig()
    p_np = RV._np_params(ref_fsp, np.float64)
    p = {k: TV._to_device(v, torch.float64, torch.device("cpu"))
         for k, v in TV._np_params(fsp, np.float64).items()}
    ref_stride = RF.make_stride_fn(np, ref_fsp, p_np, RV._opts(ref_fsp),
                                   RF.AdaptiveConfig(), np.float64)
    stride = fused.make_stride_fn(fsp, p, TV._opts(fsp), cfg,
                                  torch.float64)
    strides = []
    for t, s, s1 in pairs:
        want = int(ref_stride(s, s1, np.int32(t)))
        ts = {k: torch.from_numpy(v) for k, v in s.items()}
        ts1 = {k: torch.from_numpy(v) for k, v in s1.items()}
        got = stride(ts, ts1, torch.tensor(t))
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want, t
        strides.append(want)
        for km1 in (0.0, 3.0, float(want - 1)):
            a = RF.macro_advance(np, s, s1, np.float64(km1))
            b = fused.macro_advance(
                ts, ts1, torch.tensor(km1, dtype=torch.float64))
            for k in a:
                assert np.array_equal(np.asarray(a[k]), b[k].numpy(),
                                      equal_nan=True), (t, km1, k)
    # busy ticks everywhere; the drained incast also has quiet windows
    assert min(strides) == 1
    assert grid != "incast_no_victim" or max(strides) > 1


def test_float32_adaptive_within_bound_of_numpy_fine():
    cfg = fused.AdaptiveConfig()
    fine = RV.run_fabric_sweep(_incast_grid(SC), backend="numpy")
    got = run_fabric_sweep(_incast_grid(TSC), device="cpu",
                           dtype=torch.float32, adaptive_dt=True)
    db_f = fine["flow_delivered_bytes"]
    rel = np.abs(got["flow_delivered_bytes"] - db_f) / np.maximum(db_f, 1.0)
    assert rel.max() <= cfg.rel_bytes_bound + 5e-4, rel.max()


@pytest.mark.parametrize("with_victim", [False, True],
                         ids=["no_victim", "victim"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_iteration_equals_host_loop(dtype, with_victim):
    """The iteration the card captures (and the CPU runs) macro-advances
    at every stride, k == 1 included (k - 1 = 0 leaves the step's state
    as it is), so it equals the reference's numpy host loop, written here
    with the port's step, stride and macro advance: ``k`` read on the
    host every iteration, the advance skipped at k == 1."""
    fsp = FabricSweepParams.from_scenarios(
        _incast_grid(TSC, with_victim=with_victim))
    cfg = fused.AdaptiveConfig()
    run = FabricRun(fsp, device="cpu", dtype=dtype, adaptive=cfg)
    got = run.run()
    loop = FabricRun(fsp, device="cpu", dtype=dtype, adaptive=cfg)
    s, t, it = dict(loop.state), 0, 0
    while t < fsp.ticks:
        s1 = loop.step(s, t, it)
        k = int(loop.stride(s, s1, torch.tensor(t)))
        if k > 1:
            s1 = fused.macro_advance(s, s1, float(k - 1))
        s, t, it = s1, t + k, it + 1
    want = TV._results({k: v.numpy() for k, v in s.items()}, fsp)
    assert run.iterations == it
    assert with_victim or it < fsp.ticks
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def test_onoff_trains_keep_fine_ticks():
    sc = TSC.incast(2, mode="jet", burst_mb=0.25, sim_time_s=0.001)
    for f in sc.flows:
        f.on_off_us = (20.0, 20.0)
    fsp = FabricSweepParams.from_scenarios([sc])
    fine = run_packed(fsp, device="cpu", dtype=torch.float64)
    run = FabricRun(fsp, device="cpu", dtype=torch.float64,
                    adaptive=fused.AdaptiveConfig())
    adap = run.run()
    assert run.iterations == fsp.ticks
    assert np.array_equal(adap["flow_delivered_bytes"],
                          fine["flow_delivered_bytes"])


@pytest.mark.parametrize("graph", ["auto", False])
def test_max_stride_one_equals_fixed_dt(graph):
    """Against the chained fixed-dt body and the eager loop."""
    scens = _incast_grid(TSC, sim_s=0.001)
    fixed = run_fabric_sweep(scens, device="cpu", graph=graph)
    adap = run_fabric_sweep(scens, device="cpu",
                            adaptive=fused.AdaptiveConfig(max_stride=1))
    assert (adap.pop("adaptive_iterations") == 1000).all()
    assert adap.keys() == fixed.keys()
    for k in fixed:
        assert np.array_equal(adap[k], fixed[k], equal_nan=True), k


def test_adaptive_refuses_sparse_grids():
    """A 3-level (super-spine) grid needs the sparse engine, which the
    reference runs at the fine tick only."""
    topo = make_pod_clos(pods=2, leaves_per_pod=2, hosts_per_leaf=2)
    sc = SC.Scenario(name="pod", topology=topo, flows=[],
                     fabric=SC.FabricConfig(sim_time_s=1e-5))
    with pytest.raises(ValueError, match="dense-engine only"):
        run_fabric_sweep([sc], device="cpu", adaptive_dt=True)
    with pytest.raises(NotImplementedError):
        run_fabric_sweep([sc], device="cpu")


def test_adaptive_iterations_key_only_when_adaptive():
    scens = _incast_grid(TSC, sim_s=0.0002)
    assert "adaptive_iterations" not in run_fabric_sweep(scens,
                                                         device="cpu")
    with pytest.raises(ValueError, match="graph"):
        run_fabric_sweep(scens, device="cpu", graph=False, adaptive_dt=True)
