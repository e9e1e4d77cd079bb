"""The port's fabric grid engine against the reference's, end to end.

The slice: {jet, ddio} receivers x {PFC off, on}, 4 incast senders,
1 ms, with and without the victim flow, on shallow (1 MB) switch
buffers so that PFC pauses, tail drops and completions all happen
inside the window.  Both packages build the grid from the same
arguments.

* float64 on the CPU vs ``run_fabric_sweep(backend="numpy")`` (float64):
  the same arithmetic in the same order up to the summation order of
  small reductions, so <= 1e-9 relative, with exact counts;
* float32 on the CPU vs ``backend="jax", impl="ref"`` (float32): <= 5e-4
  relative, the ``dev_goodput_vs_numpy`` ceiling of
  ``benchmarks/bench_floors.json``;
* both with identical finite masks (a flow one engine sees complete and
  the other does not is a failure, never masked).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fabric import scenarios as SC
from repro.fabric.cc import CcConfig
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric import fused
from repro_torch.fabric.vector import (FabricSweepParams, run_fabric_sweep,
                                       run_packed)

torch.set_num_threads(1)

COMPARED = ["flow_goodput_gbps", "flow_delivered_bytes",
            "flow_completion_us", "incast_completion_us",
            "victim_goodput_gbps", "recv_goodput_gbps",
            "switch_dropped_bytes", "pause_total_us"]
EXACT = ["recv_cnp_count", "pause_fanout", "pause_tc_fanout",
         "n_pausable_links", "has_victim"]


def _grid(M, with_victim):
    scens = [M.incast(4, mode=m, burst_mb=1.0, pfc=p, sim_time_s=0.001,
                      with_victim=with_victim)
             for m in ("jet", "ddio") for p in (False, True)]
    for s in scens:
        s.fabric.switch.port_buffer_bytes = 1 << 20
    return scens


_RUNS = {}


def _run(kind, with_victim):
    key = (kind, with_victim)
    if key not in _RUNS:
        if kind == "numpy":
            out = ref_sweep(_grid(SC, with_victim), backend="numpy")
        elif kind == "jax":
            out = ref_sweep(_grid(SC, with_victim), backend="jax",
                            impl="ref")
        else:
            dt = torch.float64 if kind == "port64" else torch.float32
            out = run_fabric_sweep(_grid(TSC, with_victim), device="cpu",
                                   dtype=dt)
        _RUNS[key] = out
    return _RUNS[key]


def rel(a, b):
    """Max relative deviation, inf when the finite masks differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return float("inf")
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


VICTIM = pytest.mark.parametrize("with_victim", [True, False],
                                 ids=["victim", "no_victim"])


@VICTIM
def test_float64_matches_numpy_reference(with_victim):
    got, want = _run("port64", with_victim), _run("numpy", with_victim)
    for k in COMPARED:
        assert rel(got[k], want[k]) <= 1e-9, k
    for k in EXACT:
        assert np.array_equal(got[k], want[k]), k


@VICTIM
def test_float32_matches_jax_reference(with_victim):
    got, want = _run("port32", with_victim), _run("jax", with_victim)
    for k in COMPARED:
        assert rel(got[k], want[k]) <= 5e-4, k
    for k in EXACT:
        assert np.array_equal(got[k], want[k]), k


@VICTIM
def test_same_keys_and_dtypes_as_reference(with_victim):
    got, want = _run("port64", with_victim), _run("numpy", with_victim)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k


def test_slice_exercises_pfc_drops_and_completions():
    """The comparison grid is not vacuous: PFC points pause, lossy points
    drop, ECN-driven CNPs fire and every incast completes in 1 ms."""
    r = _run("numpy", True)
    pfc = np.array([False, True, False, True])
    assert (r["pause_fanout"][pfc] > 0).all()
    assert (r["switch_dropped_bytes"][~pfc] > 0).all()
    assert r["recv_cnp_count"].sum() > 0
    assert np.isfinite(r["incast_completion_us"]).all()


def test_runs_on_the_reference_packing():
    """Fed the reference's own packed parameters (``from_arrays``), the
    port reproduces its run on its own packing exactly."""
    scens = [SC.incast(4, mode=m, burst_mb=0.5, pfc=True,
                       sim_time_s=0.0002) for m in ("jet", "ddio")]
    ref = RefParams.from_scenarios(scens)
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    a = run_packed(FabricSweepParams.from_arrays(d), device="cpu",
                   dtype=torch.float64)
    b = run_fabric_sweep([TSC.incast(4, mode=m, burst_mb=0.5, pfc=True,
                                     sim_time_s=0.0002)
                          for m in ("jet", "ddio")],
                         device="cpu", dtype=torch.float64)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fabric_sweep(_grid(TSC, True))


def test_cuda_only_dtype_and_impl_checks():
    with pytest.raises(ValueError, match="impl"):
        run_fabric_sweep(_grid(TSC, True), device="cpu", impl="cuda")
    with pytest.raises(ValueError):
        run_fabric_sweep(_grid(TSC, True), device="cpu",
                         dtype=torch.float16)


def test_engine_forces_full_fp32_matmuls():
    torch.set_float32_matmul_precision("high")
    run_fabric_sweep([TSC.incast(2, sim_time_s=0.00001)], device="cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("make,exc", [
    (lambda M: ([M.pod_incast(sim_time_s=0.0003)], {}), None),
    (lambda M: ([_pod_fail(M.pod_incast(sim_time_s=0.0003))], {}), None),
    (lambda M: ([M.pod_incast()], {"adaptive_dt": True}), ValueError),
], ids=["pod_incast", "pod_incast_fail_link", "pod_incast_adaptive"])
def test_unsupported_features_raise(make, exc):
    """The reference's 3-level fabrics run on the sparse engine, with
    and without a link failure schedule, equal to its ``numpy`` backend
    in float64; adaptive dt on them raises ``ValueError``, as the
    reference's (adaptive dt is dense-only)."""
    scens, kw = make(TSC)
    if exc is not None:
        with pytest.raises(exc, match="dense-engine only"):
            run_fabric_sweep(scens, device="cpu", **kw)
        return
    want = ref_sweep(make(SC)[0], backend="numpy")
    got = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel(got[k], want[k]) <= 1e-9, k


@pytest.mark.parametrize("make", [
    lambda M, cc: [M.incast(4, pfc=True, sim_time_s=0.001),
                   _cc_zoo(M.incast(4, sim_time_s=0.001), cc)],
    lambda M, cc: [M.message_incast(4, sim_time_s=0.001)],
    lambda M, cc: [M.lossy_incast(4, sim_time_s=0.001)],
], ids=["cc_zoo", "message_incast", "lossy_incast"])
def test_adaptive_dt_runs_over_the_dense_layers(make):
    """Adaptive dt over the CC zoo, message and fault layers (which it
    refused before it was ported): CPU float64 equals the reference's
    numpy adaptive run, iterations included."""
    from repro.fabric.cc import CcConfig as RCc
    from repro_torch.fabric.cc import CcConfig as TCc
    want = ref_sweep(make(SC, RCc), backend="numpy", adaptive_dt=True)
    got = run_fabric_sweep(make(TSC, TCc), device="cpu",
                           dtype=torch.float64, adaptive_dt=True)
    assert np.array_equal(got["adaptive_iterations"],
                          want["adaptive_iterations"])
    for k in COMPARED:
        assert rel(got[k], want[k]) <= 1e-9, k


def _cc_zoo(s, cc=CcConfig):
    """Flows under a non-DCQCN controller (the CC zoo), no messages."""
    for f in s.flows:
        f.cc = cc(algo="timely")
    return s


def _pod_fail(s):
    """A pod fabric with a link failure schedule (the sparse engine)."""
    s.topology.fail_link("p1s0", "ss0", at_us=100.0)
    return s


def test_adaptive_dt_raises():
    """Adaptive dt runs on the static-buffer body only (captured on the
    card); the eager loop (``graph=False``) is fixed-dt and refuses it."""
    with pytest.raises(ValueError, match="adaptive"):
        run_fabric_sweep(_grid(TSC, False), device="cpu", graph=False,
                         adaptive_dt=True)


def test_cpu_run_launches_no_kernel():
    fused.reset_launches()
    run_fabric_sweep([TSC.incast(2, sim_time_s=0.00002)], device="cpu")
    assert fused.LAUNCHES == {"priority_grants": 0, "priority_admit": 0,
                              "seg_sum": 0}
