"""The port's message layer and CC zoo against the reference.

* ``repro_torch.fabric.messages`` and ``repro_torch.fabric.cc`` are
  copies of the reference modules: every helper, ``LogHistogram``,
  ``percentile_from_counts``, ``MessageTracker`` and the rate machines
  (``DcqcnRate``, ``TimelyRate``, ``HpccRate``) are held step for step
  against the reference's on seeded inputs;
* the dense tick's ``cc`` and ``msg`` branches: both packages build each
  grid from the same arguments (the 3-algorithm incast of
  ``tests/test_messages.py``, a 4-point ``message_sweep_grid``, SEND
  verbs beside WRITE); float64 on the CPU vs ``backend="numpy"``: <= 1e-9
  relative on every output, ``msg_count``, ``msg_hist`` and
  ``msg_overflow_count`` exact; float32 on the CPU vs ``backend="jax",
  impl="ref"`` within the reference's own float32 tiers (message counts
  within 8 a point, percentiles within one histogram bucket + 2 us,
  goodput within 5e-4);
* packing: ``FabricSweepParams.from_arrays`` takes the reference's
  packing of a message grid and both engines run it.

Sizes are small (4 senders, 0.5-1 ms).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.dcqcn as RD
import repro.fabric.cc as RCC
import repro.fabric.messages as RM
import repro.fabric.scenarios as RSC
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
import repro_torch.core.dcqcn as TD
import repro_torch.fabric.cc as TCC
import repro_torch.fabric.messages as TM
import repro_torch.fabric.scenarios as TSC
from repro_torch.fabric import vector as TV
from repro_torch.fabric.vector import (FabricSweepParams, run_fabric_sweep,
                                       run_packed)

torch.set_num_threads(1)

EXACT = ["msg_count", "msg_count_total", "msg_hist", "msg_overflow_count",
         "has_messages"]
BUCKET = RM.hist_ratio() - 1.0       # one bucket's width, relative
SLACK_US = 2.0                       # tests/test_messages.py JAX_SLACK_US


# --------------------------------------------------------------------------- #
# helpers: the module copies
# --------------------------------------------------------------------------- #
def test_message_constants_and_config_match():
    for name in ("VERBS", "RECOVERY_MODES", "HIST_MIN_US", "HIST_MAX_US",
                 "HIST_BUCKETS", "MSG_COUNT_EPS"):
        assert getattr(TM, name) == getattr(RM, name), name
    for kw in ({}, {"verb": "send", "msg_bytes": 4096.0, "window": 1},
               {"recovery": "selective", "rto_backoff": 1.5, "rto_cap": 3}):
        a, b = TM.MessageConfig(**kw), RM.MessageConfig(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for attr in ("op_gap_us", "extra_us", "op_rate_gbps"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert a.verb_code() == b.verb_code()
        assert a.recovery_code() == b.recovery_code()


@pytest.mark.parametrize("bad", [
    {"verb": "read"}, {"msg_bytes": 0.0}, {"window": 0},
    {"write_gap_us": 0.0}, {"send_extra_us": -1.0},
    {"recovery": "irn"}, {"rto_us": 0.0}, {"rto_backoff": 0.5},
    {"rto_cap": -1}])
def test_message_config_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        RM.MessageConfig(**bad)
    with pytest.raises(ValueError):
        TM.MessageConfig(**bad)


def test_message_helpers_match_on_seeded_inputs():
    rng = np.random.default_rng(0)
    for _ in range(200):
        mb = float(rng.choice([1024.0, 4096.0, 65536.0, 1e6]))
        b = float(rng.integers(0, 50)) * mb + float(rng.choice(
            [0.0, 1e-9 * mb, -1e-9 * mb, 0.5 * mb]))
        assert TM.msg_count(b, mb) == RM.msg_count(b, mb)
        assert TM.msg_started(b, mb) == RM.msg_started(b, mb)
    assert TM.hist_ratio() == RM.hist_ratio()
    assert TM.hist_rel_error_bound() == RM.hist_rel_error_bound()
    for v in np.concatenate([[0.5, 1.0, 1e5, 2e5],
                             rng.lognormal(3.0, 2.0, 300)]):
        assert TM.hist_bucket(float(v)) == RM.hist_bucket(float(v))
    for b in range(TM.HIST_BUCKETS):
        assert TM.hist_estimate(b) == RM.hist_estimate(b)
    vals = list(rng.lognormal(3.0, 1.0, 101))
    for q in (0.0, 50.0, 99.0, 99.9, 100.0):
        assert TM.exact_percentile(vals, q) == RM.exact_percentile(vals, q)
    assert TM.exact_percentile([], 50.0) == 0.0


def test_log_histogram_matches_step_for_step():
    rng = np.random.default_rng(1)
    a, b = TM.LogHistogram(), RM.LogHistogram()
    assert a.percentile(99.0) == b.percentile(99.0) == 0.0
    for v in np.concatenate([rng.lognormal(4.0, 2.5, 400), [3e5, 1e6]]):
        a.add(float(v))
        b.add(float(v))
        assert a.counts == b.counts and a.n == b.n
        assert a.overflow_count == b.overflow_count
    for q in (1.0, 50.0, 99.0, 99.9, 100.0):
        assert a.percentile(q) == b.percentile(q)
    assert a.rel_error_bound() == b.rel_error_bound() == math.inf
    with pytest.raises(ValueError):
        TM.LogHistogram(lo=2.0, hi=1.0)


def test_percentile_from_counts_matches_with_overflow():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 4, (5, 7, TM.HIST_BUCKETS)).astype(float)
    counts[0, 0] = 0.0
    over = rng.integers(0, 3, (5, 7)).astype(float)
    over[1] = 50.0                      # ranks inside the overflow mass
    for q in (50.0, 99.0, 99.9):
        for ov in (None, over):
            np.testing.assert_array_equal(
                TM.percentile_from_counts(counts, q, overflow=ov),
                RM.percentile_from_counts(counts, q, overflow=ov))


@pytest.mark.parametrize("window", [None, 4])
def test_message_tracker_matches_step_for_step(window):
    rng = np.random.default_rng(3)
    cfg = dict(verb="send", msg_bytes=10_000.0, window=window)
    a, b = TM.MessageTracker(TM.MessageConfig(**cfg)), \
        RM.MessageTracker(RM.MessageConfig(**cfg))
    inj = dlv = 0.0
    for t in range(400):
        inj += float(rng.uniform(0.0, 9000.0))
        if rng.random() < 0.05:         # a go-back-N re-credit
            inj -= float(rng.uniform(0.0, 0.5)) * (inj - dlv)
        dlv = min(inj, dlv + float(rng.uniform(0.0, 9000.0)))
        assert a.window_room_bytes(inj, dlv) == b.window_room_bytes(inj,
                                                                    dlv)
        a.observe(t + 1.0, inj, dlv, start_us=float(t))
        b.observe(t + 1.0, inj, dlv, start_us=float(t))
        assert (a.hw, a.done, a.outstanding, a.last_done_us) \
            == (b.hw, b.done, b.outstanding, b.last_done_us)
    assert a.latencies == b.latencies and a.done > 0
    assert a.percentile(99.0) == b.percentile(99.0)


def test_cc_config_matches_and_refuses():
    assert TCC.CC_ALGOS == RCC.CC_ALGOS
    for algo in TCC.CC_ALGOS:
        assert TCC.CcConfig(algo=algo).code() == RCC.CcConfig(algo=algo).code()
    for bad in ({"algo": "bbr"}, {"base_rtt_us": 0.0}, {"update_us": 0.0},
                {"t_low_us": 50.0}, {"hpcc_eta": 1.5}):
        with pytest.raises(ValueError):
            RCC.CcConfig(**bad)
        with pytest.raises(ValueError):
            TCC.CcConfig(**bad)


@pytest.mark.parametrize("algo", ["dcqcn", "timely", "hpcc"])
def test_rate_machines_match_step_for_step(algo):
    rng = np.random.default_rng(4)
    a = TCC.make_controller(TCC.CcConfig(algo=algo), 100.0)
    b = RCC.make_controller(RCC.CcConfig(algo=algo), 100.0)
    assert type(a).__name__ == type(b).__name__
    for _ in range(3000):
        ra, rb = a.advance(1.0), b.advance(1.0)
        assert ra == rb
        rtt = float(rng.uniform(5.0, 60.0))
        util = float(rng.uniform(0.0, 1.5))
        a.on_signal(rtt, util, 1.0)
        b.on_signal(rtt, util, 1.0)
        if rng.random() < 0.02:
            a.on_cnp()
            b.on_cnp()
        assert a.rc == b.rc
    assert TCC.make_controller(None, 25.0).rc == 25.0
    d = TD.DcqcnConfig(line_rate_gbps=40.0)
    c = TCC.make_controller(TCC.CcConfig(dcqcn=d), 100.0)
    assert isinstance(c, TD.DcqcnRate) and c.rc == 40.0
    assert TD.DcqcnRate().rc == RD.DcqcnRate().rc


# --------------------------------------------------------------------------- #
# the dense tick's cc and msg branches vs the reference engine
# --------------------------------------------------------------------------- #
def _cc_grid(SC):
    """The 3-algorithm incast of tests/test_messages.py (cc_grid), at 4
    senders and 1 ms."""
    return [SC.message_incast(4, algo=a, sim_time_s=0.001)
            for a in ("dcqcn", "timely", "hpcc")]


def _sweep(SC):
    """A 4-point message_sweep_grid: window x CC algorithm."""
    return SC.message_sweep_grid(msg_kb=(16.0,), window=(1, 16),
                                 verb=("write",), algo=("dcqcn", "hpcc"),
                                 n_senders=4, sim_time_s=0.001)[0]


def _verbs(SC):
    """SEND beside WRITE at 4 KB (the op-rate cap binds) and a flow
    without messages beside flows with them (m_bytes = inf)."""
    out = [SC.message_incast(4, algo="timely", verb=v, msg_kb=4.0,
                             window=8, sim_time_s=0.0005)
           for v in ("write", "send")]
    mixed = SC.message_incast(4, algo="hpcc", msg_kb=64.0,
                              sim_time_s=0.0005)
    mixed.fabric.msg = None
    for f in mixed.flows[:2]:
        f.msg = SC.MessageConfig(msg_bytes=32 * 1024.0, window=4)
    out.append(mixed)
    return out


GRIDS = {"cc_grid": _cc_grid, "message_sweep": _sweep, "verbs": _verbs}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                          1e-9)))


@pytest.fixture(scope="module")
def runs():
    """Each grid through the reference's numpy backend and the port's CPU
    float64 run, built from the same arguments in both packages."""
    return {name: (ref_sweep(mk(RSC), backend="numpy"),
                   run_fabric_sweep(mk(TSC), device="cpu",
                                    dtype=torch.float64))
            for name, mk in GRIDS.items()}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_float64_equals_numpy_backend(runs, name):
    want, got = runs[name]
    assert sorted(got) == sorted(want)
    for k in want:
        if k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert _rel(got[k], want[k]) <= 1e-9, k
    assert want["has_messages"].all()
    assert (want["msg_count_total"] > 0).all()


def test_cc_zoo_beats_dcqcn_tail(runs):
    """The claim of tests/test_messages.py: a delay/INT controller's
    p99 undercuts DCQCN's standing ECN-knee queue."""
    _, got = runs["cc_grid"]
    p99 = got["msg_p99_us"]
    assert min(p99[1], p99[2]) < p99[0]


def test_verbs_and_mixed_flows(runs):
    _, got = runs["verbs"]
    # SEND's per-op gap caps each flow at one 4 KB op per 0.7 us, and
    # every SEND pays send_extra_us on top of at least one tick
    send = TM.MessageConfig(verb="send", msg_bytes=4096.0)
    assert (got["flow_goodput_gbps"][1] <= send.op_rate_gbps).all()
    assert got["msg_lat_mean_us"][1] >= 1.0 + send.extra_us
    # flows without a MessageConfig count nothing
    assert (got["msg_count"][2, 2:] == 0).all()
    assert (got["msg_count"][2, :2] > 0).all()
    assert (got["msg_last_done_us"][2, 2:] == 0).all()


@pytest.mark.parametrize("name", ["cc_grid", "verbs"])
def test_float32_within_the_jax_backends_tiers(name):
    mk = GRIDS[name]
    want = ref_sweep(mk(RSC), backend="jax", impl="ref")
    got = run_fabric_sweep(mk(TSC), device="cpu")
    assert np.abs(got["msg_count_total"] - want["msg_count_total"]).max() \
        <= 8
    for k in ("msg_p50_us", "msg_p99_us", "msg_p999_us"):
        assert (np.abs(got[k] - want[k])
                <= BUCKET * want[k] + SLACK_US).all(), k
    assert _rel(got["flow_goodput_gbps"], want["flow_goodput_gbps"]) <= 5e-4


def test_packing_matches_reference():
    ref = RefParams.from_scenarios(_sweep(RSC))
    port = FabricSweepParams.from_scenarios(_sweep(TSC))
    assert (port.any_cc, port.any_msg, port.msg_ring, port.any_flt) \
        == (ref.any_cc, ref.any_msg, ref.msg_ring, ref.any_flt) \
        == (True, True, 20, False)
    assert sorted(port.pvals) == sorted(ref.pvals)
    for k, v in ref.pvals.items():
        assert port.pvals[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port.pvals[k], v, err_msg=k)


def test_from_arrays_runs_the_reference_packing(runs):
    """The reference's packing of a message grid (a dynamic-routing one
    too) goes through ``from_arrays`` and the port's engine."""
    ref = RefParams.from_scenarios(_sweep(RSC))
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = run_packed(FabricSweepParams.from_arrays(d), device="cpu",
                     dtype=torch.float64)
    _, want = runs["message_sweep"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scens = RSC.routing_grid(modes=("static_ecmp", "adaptive"),
                             fail_at_us=(150.0,), n_senders=2,
                             sim_time_s=0.0002)[0]
    for s in scens:
        s.fabric.msg = RM.MessageConfig()
    ref = RefParams.from_scenarios(scens)
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = run_packed(FabricSweepParams.from_arrays(d), device="cpu",
                     dtype=torch.float64)
    want = ref_sweep(scens, backend="numpy")
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-9, k


def test_unbounded_window_raises():
    sc = TSC.message_incast(2, sim_time_s=0.0001, window=None)
    with pytest.raises(ValueError, match="window=None"):
        run_fabric_sweep([sc], device="cpu")


def test_unsupported_features_name_only_the_sparse_engine():
    scens = _cc_grid(RSC) + [RSC.lossy_incast(4)]
    assert TV.unsupported_features(scens) == []
    assert TV.unsupported_features(_cc_grid(TSC)) == []
    assert TV.unsupported_features([RSC.pod_incast()]) == [
        "3-level super-spine fabrics (sparse incidence)"]
