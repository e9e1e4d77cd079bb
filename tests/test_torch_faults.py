"""The port's fault layer against the reference.

* ``repro_torch.fabric.faults`` is a copy of the reference module: the
  counter hashes, salts and thresholds equal the reference's over ticks
  past 65,536 and many salts, the engine's split-modmul drop mask equals
  the scalar hashes on every (tick, link), ``FaultConfig`` validates as
  the reference does and ``FlowRecovery`` moves step for step with the
  reference's; the vectorized PFC-deadlock watchdog
  (``fused.cycle_flags``) equals ``has_pause_cycle`` on the synthetic
  masks of ``tests/test_fused.py``;
* the dense tick's ``flt`` branch: both packages build each grid from
  the same arguments (``tests/test_faults.py``'s 2 % lossy incast beside
  a clean point, go-back-N and selective at 0.5 % and 2 %, the crash
  scenario, a link outage and a flap under faults, ``FaultConfig()``
  with PFC for the watchdog, an RTO backoff of 1.5); float64 on the CPU
  vs ``backend="numpy"``: <= 1e-9 relative on every output, message
  counts and ``deadlock_ticks`` exact; float32 on the CPU vs
  ``backend="jax", impl="ref"`` within the reference's float32 tiers
  (dropped packets and retransmitted bytes within 1e-4, counts within 8
  a point, crash completion and recovery within a tick, goodput within
  5e-4);
* packing: the reference's packing of a lossy grid runs through
  ``FabricSweepParams.from_arrays``.

Sizes are small (4 senders, 0.5-1 ms).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.fabric.faults as RF
import repro.fabric.fused as RFU
import repro.fabric.scenarios as RSC
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
import repro_torch.fabric.faults as TF
import repro_torch.fabric.fused as TFU
import repro_torch.fabric.scenarios as TSC
from repro_torch.fabric import vector as TV
from repro_torch.fabric.vector import (FabricSweepParams, run_fabric_sweep,
                                       run_packed)

torch.set_num_threads(1)

REF = dict(SC=RSC, F=RF)
PORT = dict(SC=TSC, F=TF)
EXACT = ["msg_count", "msg_count_total", "msg_hist", "deadlock_ticks",
         "has_messages", "pause_fanout"]


# --------------------------------------------------------------------------- #
# helpers: the module copy, the drop mask, the watchdog
# --------------------------------------------------------------------------- #
def test_hash_helpers_equal_the_reference():
    assert (TF.HASH_MOD, TF._LOSS_MULT, TF._CORRUPT_MULT, TF._SALT_MULT) \
        == (RF.HASH_MOD, RF._LOSS_MULT, RF._CORRUPT_MULT, RF._SALT_MULT)
    names = [("leaf0", "spine0"), ("spine1", "leaf1"), ("leaf1", "h1_0"),
             ("h0_3", "leaf0")]
    for (a, b) in names:
        for seed in (0, 3, 7, 12345):
            assert TF.link_salt(a, b, seed) == RF.link_salt(a, b, seed)
    for r in (0.0, 1e-6, 0.002, 0.0123, 0.5, 1.0):
        assert TF.loss_threshold(r) == RF.loss_threshold(r)
    ticks = list(range(0, 300)) + list(range(65_500, 65_700)) \
        + [131_071, 131_072, 10 ** 6, 2 ** 31 - 2]
    for salt in (0, 1, 9973, 40_000, 65_535):
        for t in ticks:
            assert TF.fault_hash(t, salt) == RF.fault_hash(t, salt)
            assert TF.corrupt_hash(t, salt) == RF.corrupt_hash(t, salt)
    for t in range(0, 400, 7):
        assert TF.flap_down_now(t, 50, 120, 30) \
            == RF.flap_down_now(t, 50, 120, 30)
        assert TF.flap_edge(t, 50, 120) == RF.flap_edge(t, 50, 120)


def test_drop_mask_equals_the_scalar_hashes():
    """The engine's split-modmul masks ([G, P] integer tensors) equal the
    scalar hashes against the thresholds on every tick, past 65,536."""
    rng = np.random.default_rng(0)
    salts = rng.integers(0, 65536, (3, 11))
    thr = rng.integers(0, 4000, (3, 11))
    cthr = np.where(rng.random((3, 11)) < 0.3, 3000, 0)
    sp = TV.fault_saltp(torch.as_tensor(salts))
    for t in list(range(0, 2000, 3)) + list(range(65_530, 65_545)) \
            + [200_000, 2 ** 31 - 2]:
        got = TV.fault_drops(t, sp, torch.as_tensor(thr),
                             torch.as_tensor(cthr)).numpy()
        want = np.array([[RF.fault_hash(t, int(s)) < th
                          or RF.corrupt_hash(t, int(s)) < ct
                          for s, th, ct in zip(srow, trow, crow)]
                         for srow, trow, crow in zip(salts, thr, cthr)])
        np.testing.assert_array_equal(got, want, err_msg=str(t))


def test_fault_config_matches_and_refuses():
    a = TF.FaultConfig(0.01, 0.002, link_loss={("a", "b"): 0.5},
                       seed=3).crash("h1_0", 100.0, 300.0)
    b = RF.FaultConfig(0.01, 0.002, link_loss={("a", "b"): 0.5},
                       seed=3).crash("h1_0", 100.0, 300.0)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.rate_for("a", "b") == b.rate_for("a", "b") == 0.5
    assert a.rate_for("x", "y") == b.rate_for("x", "y") == 0.01
    assert a.any_loss and b.any_loss
    assert not TF.FaultConfig().any_loss
    for bad in ({"loss_rate": 1.5}, {"corrupt_rate": -0.1},
                {"link_loss": {("a", "b"): 2.0}},
                {"crashes": {"h": (5.0, 5.0)}}, {"mtu_bytes": 0.0}):
        with pytest.raises(ValueError):
            RF.FaultConfig(**bad)
        with pytest.raises(ValueError):
            TF.FaultConfig(**bad)


@pytest.mark.parametrize("kw", [
    dict(selective=False, rto_us=50.0, backoff=2.0, cap=6, nack_us=8.0),
    dict(selective=False, rto_us=30.0, backoff=1.5, cap=4, nack_us=8.0),
    dict(selective=True, rto_us=50.0, backoff=2.0, cap=6, nack_us=8.0)],
    ids=["go_back_n", "backoff_1.5", "selective"])
def test_flow_recovery_matches_step_for_step(kw):
    rng = np.random.default_rng(5)
    a = TF.FlowRecovery(dt_us=1.0, **kw)
    b = RF.FlowRecovery(dt_us=1.0, **kw)
    for _ in range(3000):
        if rng.random() < 0.03:
            x = float(rng.uniform(0.0, 5e4))
            a.on_loss(x)
            b.on_loss(x)
        arr = float(rng.uniform(0.0, 1e4))
        assert a.on_arrival(arr) == b.on_arrival(arr)
        prog = bool(rng.random() < 0.3)
        assert a.deadline_ticks() == b.deadline_ticks()
        assert a.tick(prog) == b.tick(prog)
        assert (a.lost, a.timer, a.k, a.gapped, a.retx_bytes,
                a.dup_bytes) == (b.lost, b.timer, b.k, b.gapped,
                                 b.retx_bytes, b.dup_bytes)
    assert a.retx_bytes > 0.0
    m = TF.FlowRecovery.from_msg(TSC.MessageConfig(recovery="selective"),
                                 1.0)
    assert m.sel and m.nack_ticks == 8


def test_cycle_flags_match_has_pause_cycle_on_synthetic_masks():
    """The six masks of tests/test_fused.py: a 3-cycle in one class, an
    open chain, the cycle's edges split across classes, nothing paused,
    a ping-pong in one class, and split across classes."""
    port_keys = [("a", "b"), ("b", "c"), ("c", "a"), ("b", "a")]
    E = TFU.pause_pair_onehot(port_keys)
    np.testing.assert_array_equal(E, RFU.pause_pair_onehot(port_keys))
    cases = [{(0, 0), (1, 0), (2, 0)}, {(0, 0), (1, 0)},
             {(0, 0), (1, 1), (2, 2)}, set(), {(0, 1), (3, 1)},
             {(0, 0), (3, 1)}]
    lp = np.zeros((len(cases) + 1, 3, len(port_keys)))
    want = []
    for i, case in enumerate(cases):
        for pi, tc in case:
            lp[i, tc, pi] = 1.0
        want.append(TF.has_pause_cycle([(port_keys[pi], tc)
                                        for pi, tc in case]))
        assert want[-1] == RF.has_pause_cycle([(port_keys[pi], tc)
                                               for pi, tc in case])
    want.append(False)                  # the all-zero point never flags
    assert want[:6] == [True, False, False, False, True, False]
    for dt in (torch.float64, torch.float32):
        got = TFU.cycle_flags(torch.as_tensor(lp, dtype=dt),
                              torch.as_tensor(E, dtype=dt), 3)
        assert got.tolist() == want
        np.testing.assert_array_equal(
            got.numpy(), RFU.cycle_flags(np, lp, E, 3, 1.0))


# --------------------------------------------------------------------------- #
# the dense tick's flt branch vs the reference engine
# --------------------------------------------------------------------------- #
def _lossy_and_clean(M):
    """tests/test_faults.py's lossy_scen (2 % loss, seed 3) beside the
    same incast with faults=None in one grid."""
    sc = M["SC"].message_incast(4, msg_kb=16.0, window=8, sim_time_s=0.001)
    f = M["F"].FaultConfig(loss_rate=0.02, seed=3)
    lossy = dataclasses.replace(
        sc, fabric=dataclasses.replace(sc.fabric, faults=f))
    return [lossy, M["SC"].message_incast(4, msg_kb=16.0, window=8,
                                          sim_time_s=0.001)]


def _recovery(M):
    """go-back-N and selective at 0.5 % and 2 % loss."""
    return M["SC"].lossy_incast_grid(
        loss_rate=(0.005, 0.02), recovery=("go_back_n", "selective"),
        n_senders=4, sim_time_s=0.001)[0]


def _crash(M):
    """tests/test_faults.py's crash scenario: receiver down 100-200 us
    under 0.5 % loss, closed bursts, go-back-N."""
    sc = M["SC"].lossy_incast(n_senders=4, loss_rate=0.005,
                              recovery="go_back_n", msg_kb=16.0, window=8,
                              sim_time_s=0.001)
    flows = [dataclasses.replace(f, burst_bytes=0.4e6) for f in sc.flows]
    sc = dataclasses.replace(sc, flows=flows)
    sc.fabric.faults = M["F"].FaultConfig(loss_rate=0.005, seed=7).crash(
        "h1_0", 100.0, 200.0)
    return [sc]


def _outage(M):
    """A flap under FaultConfig(seed=0) (tests/test_faults.py:410) and a
    lossy incast across a leaf0 -> spine0 outage (:381)."""
    sc = M["SC"].message_incast(4, msg_kb=16.0, window=8,
                                sim_time_s=0.0008)
    sc.topology.flap_link("leaf0", "spine0", start_us=300.0,
                          period_us=120.0, down_us=30.0)
    sc.fabric.faults = M["F"].FaultConfig(seed=0)
    out = M["SC"].lossy_incast(n_senders=4, loss_rate=0.01, msg_kb=16.0,
                               window=8, sim_time_s=0.0008)
    out.topology.fail_link("leaf0", "spine0", at_us=20.0, restore_us=400.0)
    return [sc, out]


def _watchdog(M):
    """FaultConfig() on a PFC incast and a PFC all-to-all (the watchdog's
    grids of tests/test_fused.py)."""
    a = M["SC"].incast(4, mode="ddio", burst_mb=1.0, sim_time_s=0.0005,
                       pfc=True)
    a.fabric.faults = M["F"].FaultConfig()
    return [a]


def _a2a(M):
    a = M["SC"].all_to_all(4, mode="ddio", msg_kb=256, pfc=True,
                           sim_time_s=0.0005)
    a.fabric.faults = M["F"].FaultConfig(loss_rate=0.01, seed=1)
    return [a]


def _backoff(M):
    """go-back-N with an RTO backoff of 1.5 (not a power of two) and a
    cap of 3, beside the default 2.0."""
    out = []
    for mult in (1.5, 2.0):
        sc = M["SC"].lossy_incast(n_senders=4, loss_rate=0.02,
                                  recovery="go_back_n", msg_kb=16.0,
                                  window=8, sim_time_s=0.0008)
        for f in sc.flows:
            f.msg = M["SC"].MessageConfig(msg_bytes=16 * 1024.0, window=8,
                                          rto_us=20.0, rto_backoff=mult,
                                          rto_cap=3)
        out.append(sc)
    return out


GRIDS = {"lossy_and_clean": _lossy_and_clean, "recovery": _recovery,
         "crash": _crash, "outage_and_flap": _outage,
         "watchdog": _watchdog, "all_to_all": _a2a, "backoff": _backoff}


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
    return {}


def _pair(runs, name):
    """A grid through the reference's numpy backend and the port's CPU
    float64 run (built once per module)."""
    if name not in runs:
        runs[name] = (ref_sweep(GRIDS[name](REF), backend="numpy"),
                      run_fabric_sweep(GRIDS[name](PORT), device="cpu",
                                       dtype=torch.float64))
    return runs[name]


@pytest.mark.parametrize("name", list(GRIDS))
def test_float64_equals_numpy_backend(runs, name):
    want, got = _pair(runs, name)
    assert sorted(got) == sorted(want)
    for k in want:
        if k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert _rel(got[k], want[k]) <= 1e-9, k


def test_clean_point_reports_no_fault(runs):
    _, got = _pair(runs, "lossy_and_clean")
    assert got["retransmit_bytes"][1] == 0.0
    assert got["dropped_pkts"][1] == 0.0
    assert got["retransmit_bytes"][0] > 0.0 and got["dropped_pkts"][0] > 0.0


def test_selective_beats_go_back_n(runs):
    """The IRN claim of tests/test_faults.py at 2 % loss: selective
    retransmits less than half of go-back-N's bytes and completes more
    messages."""
    _, got = _pair(runs, "recovery")
    # points ordered (loss_rate, recovery): 0.005 gbn, sel; 0.02 gbn, sel
    retx, cnt = got["retransmit_bytes"], got["msg_count_total"]
    assert retx[3] < 0.5 * retx[2]
    assert cnt[3] > cnt[2]
    assert retx[2] > retx[0]


def test_crash_recovers(runs):
    _, got = _pair(runs, "crash")
    rec = got["crash_recovery_us"][0, 0]
    assert math.isfinite(rec) and rec > 100.0
    assert got["retransmit_bytes"][0] > 0.0


def test_backoff_changes_the_timers(runs):
    """A backoff of 1.5 waits less than 2.0 after repeated losses, so the
    two points part."""
    _, got = _pair(runs, "backoff")
    assert got["retransmit_bytes"][0] != got["retransmit_bytes"][1]


@pytest.mark.parametrize("name", ["recovery", "crash"])
def test_float32_within_the_jax_backends_tiers(name):
    want = ref_sweep(GRIDS[name](REF), backend="jax", impl="ref")
    got = run_fabric_sweep(GRIDS[name](PORT), device="cpu")
    for k in ("dropped_pkts", "retransmit_bytes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert np.abs(got["msg_count_total"] - want["msg_count_total"]).max() \
        <= 8
    for k in ("flow_completion_us", "crash_recovery_us"):
        a, b = got[k], want[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert (np.abs(a[m] - b[m]) <= 1.0).all(), k
    assert _rel(got["flow_goodput_gbps"], want["flow_goodput_gbps"]) <= 5e-4
    np.testing.assert_array_equal(got["deadlock_ticks"],
                                  want["deadlock_ticks"])


def test_packing_and_from_arrays(runs):
    ref = RefParams.from_scenarios(_recovery(REF))
    port = FabricSweepParams.from_scenarios(_recovery(PORT))
    assert (port.any_flt, port.any_msg, port.msg_ring) \
        == (ref.any_flt, ref.any_msg, ref.msg_ring) == (True, True, 20)
    assert sorted(port.pvals) == sorted(ref.pvals)
    for k, v in ref.pvals.items():
        assert port.pvals[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port.pvals[k], v, err_msg=k)
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = run_packed(FabricSweepParams.from_arrays(d), device="cpu",
                     dtype=torch.float64)
    _, want = _pair(runs, "recovery")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_crash_of_an_unknown_host_raises():
    sc = TSC.message_incast(2, msg_kb=16.0, window=4, sim_time_s=0.0001)
    sc.fabric.faults = TF.FaultConfig().crash("h0_0", 100.0, 200.0)
    with pytest.raises(ValueError, match="crash"):
        run_fabric_sweep([sc], device="cpu")
