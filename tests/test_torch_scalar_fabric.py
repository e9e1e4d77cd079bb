"""The port's multi-host scalar engines against the reference, bit for
bit, on the CPU: ``OutputPort`` / ``Switch`` on seeded random operation
sequences, ``SenderHost`` under DCQCN, Timely and HPCC, and ``run_fabric``
(through ``Scenario.run``) with every ``FabricResult`` field equal with
``==`` — NaN and inf in the same places, dict keys in the same order,
message latency lists element for element.

Then the port's own grid engine against its new scalar driver, the
reference's numpy-vs-scalar contracts held inside the port: CPU float64
``run_fabric_sweep`` within 1e-9 of ``run_fabric``, completions and
message counts exact.

Both packages build each case from the same arguments.  Depths are 1-2
ms (the reference's scalar tests run 2-15 ms), each long enough for its
branch to fire: the failure, the flap, the crash and the PFC pauses all
sit inside the window.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _scalar_same import mismatches
import repro.core.simulator as RS
import repro.fabric.cc as RCC
import repro.fabric.faults as RF
import repro.fabric.fabric as RFB
import repro.fabric.hosts as RH
import repro.fabric.scenarios as RSC
import repro.fabric.switch as RSW
import repro.fabric.topology as RT
from repro.core.datapath import QoS as RQoS
from repro.core.dcqcn import DcqcnConfig as RDcqcn
import repro_torch.core.simulator as TS
import repro_torch.fabric.cc as TCC
import repro_torch.fabric.faults as TF
import repro_torch.fabric.fabric as TFB
import repro_torch.fabric.hosts as TH
import repro_torch.fabric.scenarios as TSC
import repro_torch.fabric.switch as TSW
import repro_torch.fabric.topology as TT
from repro_torch.core.datapath import QoS as TQoS
from repro_torch.core.dcqcn import DcqcnConfig as TDcqcn
from repro_torch.fabric import run_fabric_sweep

torch.set_num_threads(1)

REF = dict(S=RS, CC=RCC, F=RF, FB=RFB, SC=RSC, SW=RSW, T=RT, Q=RQoS)
PORT = dict(S=TS, CC=TCC, F=TF, FB=TFB, SC=TSC, SW=TSW, T=TT, Q=TQoS)


def assert_same(got, want):
    bad = mismatches(got, want)
    assert not bad, bad[:5]


# --------------------------------------------------------------------------- #
# OutputPort / Switch on seeded random operation sequences
# --------------------------------------------------------------------------- #
LINKS = [None, ("h0", "leaf0"), ("h1", "leaf0"), ("spine0", "leaf0")]
PORT_STATE = ("tcq", "flow_ingress", "static_ingress", "paused",
              "paused_tcs", "tc_asserted", "dropped_bytes", "marked_bytes",
              "pause_us", "peak_bytes", "_tc_bytes", "_total_bytes",
              "queued_bytes", "pause_asserted", "flows")


def _switch_cfg(M, rng):
    per_tc = [float(x) for x in rng.uniform(0.05, 0.5, 3)]
    return M["SW"].SwitchConfig(
        port_buffer_bytes=int(rng.choice([256 << 10, 1 << 20])),
        ecn_enabled=bool(rng.random() < 0.8),
        ecn_kmin_frac=float(rng.uniform(0.0, 0.4)),
        pfc_enabled=bool(rng.random() < 0.8),
        pfc_xoff_frac=float(rng.uniform(0.4, 0.8)),
        pfc_xon_frac=float(rng.uniform(0.1, 0.4)),
        scheduler="wrr" if rng.random() < 0.5 else "strict",
        wrr_quanta=(None if rng.random() < 0.5
                    else [float(x) for x in rng.uniform(0.5, 5.0, 3)]),
        tc_ecn_kmin_frac=per_tc if rng.random() < 0.3 else None,
        tc_pfc_xoff_frac=[0.7, 0.6, 0.5] if rng.random() < 0.3 else None,
        tc_pfc_xon_frac=[0.3, 0.2, 0.1] if rng.random() < 0.3 else None)


def _items(rng):
    out = []
    for _ in range(int(rng.integers(1, 7))):
        b = 0.0 if rng.random() < 0.1 else float(rng.exponential(2e5))
        m = b * float(rng.random()) if rng.random() < 0.5 else 0.0
        out.append((int(rng.integers(0, 8)), b, m,
                    LINKS[int(rng.integers(0, len(LINKS)))],
                    int(rng.integers(0, 3))))
    return out


def _port_ops(seed, n=80):
    """One op sequence for both packages: (name, argument) pairs."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        u = rng.random()
        if u < 0.35:
            ops.append(("enqueue_batch", _items(rng)))
        elif u < 0.45:
            fid, b, m, lk, tc = _items(rng)[0]
            ops.append(("enqueue", (fid, b, m, lk, tc)))
        elif u < 0.75:
            ops.append(("drain", float(rng.choice([0.5, 1.0, 2.0]))))
        elif u < 0.85:
            ops.append(("update_pfc", None))
        elif u < 0.93:
            tcs = frozenset(int(x) for x in np.flatnonzero(
                rng.random(3) < 0.3))
            ops.append(("pause", (tcs, bool(rng.random() < 0.2))))
        elif u < 0.97:
            ops.append(("static_ingress", {
                int(f): tuple(LINKS[1:1 + int(rng.integers(1, 4))])
                for f in range(0, 8, 2)} if rng.random() < 0.7 else None))
        else:
            ops.append(("drop_all", None))
    return rng, ops


def _apply(port, op, arg):
    if op == "enqueue_batch":
        return port.enqueue_batch(arg)
    if op == "enqueue":
        return port.enqueue(*arg)
    if op == "drain":
        return port.drain(arg)
    if op == "update_pfc":
        port.update_pfc()
        return port.pause_targets()
    if op == "pause":
        port.paused_tcs, port.paused = arg
        return None
    if op == "static_ingress":
        port.static_ingress = arg
        return port.pause_targets()
    return port.drop_all()


def _port_state(p):
    return {k: getattr(p, k) for k in PORT_STATE}


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 1 << 30))
def test_output_port_matches_reference(seed):
    rng, ops = _port_ops(seed)
    cfg_seed = int(rng.integers(0, 1 << 30))
    ports = []
    for M in (PORT, REF):
        link = M["T"].Link("leaf0", "h9", float([25.0, 100.0, 400.0][
            seed % 3]))
        ports.append(M["SW"].OutputPort(
            link, _switch_cfg(M, np.random.default_rng(cfg_seed))))
    t, r = ports
    for op, arg in ops:
        assert_same(_apply(t, op, arg), _apply(r, op, arg))
        assert_same(_port_state(t), _port_state(r))
        for tc in range(3):
            assert t.tc_bytes(tc) == r.tc_bytes(tc)
        if op == "drain" and t.cfg.scheduler == "wrr":
            assert t._wrr_fracs(1e4) == r._wrr_fracs(1e4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1 << 30))
def test_switch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cfg_seed = int(rng.integers(0, 1 << 30))
    sws = []
    for M in (PORT, REF):
        L = M["T"].Link
        out = [L("leaf0", "h9", 100.0), L("leaf0", "spine0", 400.0),
               L("leaf0", "spine1", 400.0)]
        sws.append(M["SW"].Switch(
            "leaf0", out, _switch_cfg(M, np.random.default_rng(cfg_seed))))
    t, r = sws
    assert list(t.ports) == list(r.ports)
    dsts = list(t.ports)
    for _ in range(60):
        for _ in range(int(rng.integers(0, 5))):
            fid, b, m, lk, tc = _items(rng)[0]
            d = dsts[int(rng.integers(0, len(dsts)))]
            assert t.enqueue(d, fid, b, m, lk, tc) \
                == r.enqueue(d, fid, b, m, lk, tc)
        for d in dsts:
            assert_same(t.ports[d].drain(1.0), r.ports[d].drain(1.0))
        assert t.update_pfc() == r.update_pfc()
        assert (t.dropped_bytes(), t.marked_bytes(), t.queued_bytes()) \
            == (r.dropped_bytes(), r.marked_bytes(), r.queued_bytes())


# --------------------------------------------------------------------------- #
# SenderHost under the CC zoo
# --------------------------------------------------------------------------- #
SENDERS = {
    "dcqcn_default": dict(),
    "dcqcn_explicit": dict(dcqcn=True, offered_gbps=60.0),
    "dcqcn_burst_train": dict(burst_bytes=3e6, start_us=20.0,
                              on_off_us=(50.0, 30.0)),
    "timely": dict(cc="timely", burst_bytes=5e6, op_cap_gbps=70.0),
    "hpcc": dict(cc="hpcc", offered_gbps=90.0),
}


def _sender(M, kw):
    kw = dict(kw)
    if kw.pop("dcqcn", False):
        kw["dcqcn"] = (TDcqcn if M is PORT else RDcqcn)(
            line_rate_gbps=100.0, ai_rate_gbps=8.0)
    if "cc" in kw:
        kw["cc"] = M["CC"].CcConfig(algo=kw["cc"], update_us=8.0)
    return (TH if M is PORT else RH).SenderHost(100.0, **kw)


@pytest.mark.parametrize("case", sorted(SENDERS))
def test_sender_host_matches_reference(case):
    t, r = _sender(PORT, SENDERS[case]), _sender(REF, SENDERS[case])
    rng = np.random.default_rng(sorted(SENDERS).index(case))
    offered = 0.0
    for tick in range(3000):
        room = None if rng.random() < 0.6 else float(rng.exponential(5e4))
        got, want = t.offer(1.0, window_room=room), \
            r.offer(1.0, window_room=room)
        assert got == want, tick
        offered += got
        u = rng.random()
        if u < 0.05:
            t.on_cnp()
            r.on_cnp()
        elif u < 0.5:
            rtt, util = float(rng.uniform(8.0, 60.0)), float(rng.random())
            t.on_signal(rtt, util, 1.0)
            r.on_signal(rtt, util, 1.0)
        elif u < 0.55:
            b = float(rng.uniform(0.0, 1e4))
            t.credit(b)
            r.credit(b)
        assert (t.injected, t.exhausted, t.now_us) \
            == (r.injected, r.exhausted, r.now_us)
        assert_same(vars(t.rate), vars(r.rate))
    assert offered > 0.0


def test_sender_host_rejects_bad_duty_cycle():
    for bad in ((0.0, 10.0), (5.0, -1.0)):
        msgs = []
        for H in (TH, RH):
            with pytest.raises(ValueError) as e:
                H.SenderHost(100.0, on_off_us=bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# run_fabric / Scenario.run, every field ==
# --------------------------------------------------------------------------- #
def _flap(M):
    s = M["SC"].link_failure_incast(n_senders=4, routing="adaptive",
                                    burst_mb=0.5, fail_at_us=math.inf,
                                    sim_time_s=0.001)
    s.topology.flap_link("leaf0", "spine1", start_us=40.0, period_us=100.0,
                         down_us=30.0)
    return [s]


def _wrr_pair(M, sim_time_s=0.001):
    """The port's ``wrr_pair``; the reference has no builder, so its twin
    is built from the same arguments (tests/test_routing.py's case)."""
    if M is PORT:
        return TSC.wrr_pair(sim_time_s)
    topo = RT.incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [RFB.Flow(src=f"h0_{i}", dst="h1_0", offered_gbps=60.0,
                      qos=RQoS.HIGH, tag="hi") for i in range(3)]
    flows.append(RFB.Flow(src="h0_3", dst="h1_0", offered_gbps=40.0,
                          qos=RQoS.LOW, tag="low"))
    out = []
    for sched in ("strict", "wrr"):
        sw = RSW.SwitchConfig(pfc_enabled=False, ecn_enabled=False,
                              scheduler=sched, port_buffer_bytes=1 << 20)
        fc = RFB.FabricConfig(sim_time_s=sim_time_s, switch=sw,
                              receiver_cfg=lambda h: RS.testbed_100g("ddio"))
        out.append(RSC.Scenario(name=sched, topology=topo, flows=flows,
                                fabric=fc))
    return out


def _host_pair(M, sim_time_s=0.001):
    """The port's ``host_gate_pair`` and its reference twin."""
    if M is PORT:
        return TSC.host_gate_pair(sim_time_s)
    topo = RT.incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [RFB.Flow(src=f"h0_{i}", dst="h1_0", qos=RQoS.LOW, tag="bulk")
             for i in range(3)]
    flows.append(RFB.Flow(src="h0_3", dst="h1_0", offered_gbps=1.0,
                          qos=RQoS.HIGH, tag="hi"))
    out = []
    for per_tc in (False, True):
        def recv(host, per_tc=per_tc):
            return RS.testbed_100g("ddio", pfc_enabled=True,
                                   host_pfc_per_tc=per_tc,
                                   rnic_ecn_cnp=False, cpu_membw_gbps=1995.0)
        fc = RFB.FabricConfig(sim_time_s=sim_time_s,
                              switch=RSW.SwitchConfig(pfc_enabled=True),
                              receiver_cfg=recv)
        out.append(RSC.Scenario(name=f"host_gate_{per_tc}", topology=topo,
                                flows=flows, fabric=fc))
    return out


def _lossy(M):
    gbn = M["SC"].lossy_incast(n_senders=4, loss_rate=0.01,
                               recovery="go_back_n", sim_time_s=0.001)
    sel = M["SC"].lossy_incast(n_senders=4, loss_rate=0.01,
                               recovery="selective", sim_time_s=0.001)
    crash = M["SC"].lossy_incast(n_senders=4, loss_rate=0.005,
                                 recovery="selective", sim_time_s=0.001)
    crash.fabric.faults = M["F"].FaultConfig(0.005, seed=7).crash(
        "h1_0", at_us=300.0, restart_us=450.0)
    return [gbn, sel, crash]


CASES = {
    "single_pair": lambda M: [M["SC"].single_pair(m, sim_time_s=0.002)
                              for m in ("ddio", "jet")],
    "incast8": lambda M: [M["SC"].incast(n_senders=8, mode=m, pfc=p,
                                         burst_mb=1.0, sim_time_s=0.002)
                          for m in ("ddio", "jet") for p in (False, True)],
    "storage_mix": lambda M: [M["SC"].storage_mix(k, sim_time_s=0.002)
                              for k in ("oltp", "olap", "backup")],
    "routing_grid": lambda M: M["SC"].routing_grid(
        modes=("static_ecmp", "weighted_ecmp", "adaptive", "spray"),
        fail_at_us=(math.inf, 30.0), burst_mb=1.0, n_senders=4,
        sim_time_s=0.001)[0],
    "flap": _flap,
    "message_incast": lambda M: [M["SC"].message_incast(
        8, algo=a, sim_time_s=0.001) for a in ("dcqcn", "timely", "hpcc")],
    "lossy_incast": _lossy,
    "qos_mixed_storage": lambda M: [M["SC"].qos_mixed_storage(
        per_tc=p, sim_time_s=0.001) for p in (False, True)],
    "wrr_pair": _wrr_pair,
    "host_gate_pair": _host_pair,
    "pod_incast": lambda M: [M["SC"].pod_incast(
        pods=2, leaves_per_pod=2, hosts_per_leaf=2, burst_mb=0.3, pfc=True,
        sim_time_s=0.001)],
    "pod_pfc_storm": lambda M: [M["SC"].pod_pfc_storm(
        pods=2, leaves_per_pod=2, hosts_per_leaf=2, buffer_kb=32.0,
        sim_time_s=0.001)],
}

_RUNS = {}


def _runs(case, M):
    key = (case, M is PORT)
    if key not in _RUNS:
        _RUNS[key] = [s.run() for s in CASES[case](M)]
    return _RUNS[key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_fabric_equals_reference(case):
    got, want = _runs(case, PORT), _runs(case, REF)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__module__ == "repro_torch.fabric.fabric"
        assert_same(g, w)
        assert g.pause_storm() == w.pause_storm()
        assert g.uplink_imbalance() == w.uplink_imbalance()
        for tag in ("incast", "victim", "hi", "low", "bulk", "oltp", "none"):
            assert g.has_tag(tag) == w.has_tag(tag)
            assert g.tagged_goodput(tag) == w.tagged_goodput(tag)
        for tag in (None, "incast", "msg"):
            assert g.msg_count(tag) == w.msg_count(tag)
            assert g.msg_rate_mops(tag) == w.msg_rate_mops(tag)
            for q in (50.0, 99.0, 99.9):
                assert g.msg_percentile(q, tag) == w.msg_percentile(q, tag)


def test_cases_exercise_their_branches():
    """Each case reaches what it is there for, so an equality above is not
    an equality of idle runs."""
    inc = _runs("incast8", PORT)
    assert max(r.pause_fanout for r in inc) >= 2
    assert max(r.switch_dropped_bytes for r in inc) > 0.0
    routing = _runs("routing_grid", PORT)
    assert any(r.reroute_count > 0 for r in routing)
    assert any(math.isinf(r.incast_completion_us) for r in routing)
    assert _runs("flap", PORT)[0].reroute_count > 0
    msgs = _runs("message_incast", PORT)
    assert all(r.has_messages and r.msg_count() > 0 for r in msgs)
    gbn, sel, crash = _runs("lossy_incast", PORT)
    assert gbn.retransmit_bytes > sel.retransmit_bytes > 0.0
    assert gbn.dropped_pkts > 0.0
    assert math.isfinite(crash.crash_recovery_us["h1_0"])
    strict, wrr = _runs("wrr_pair", PORT)
    assert wrr.tagged_goodput("low") > strict.tagged_goodput("low")
    link, per_tc = _runs("host_gate_pair", PORT)
    assert per_tc.tagged_goodput("hi") > link.tagged_goodput("hi")
    assert _runs("pod_pfc_storm", PORT)[0].pause_storm() > 0.0
    assert any(r.pause_tc_fanout for r in _runs("qos_mixed_storage", PORT))


# --------------------------------------------------------------------------- #
# the port's grid engine against its scalar driver
# --------------------------------------------------------------------------- #
def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b)), (a, b)
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


def _stack(results, key, F):
    return np.array([[getattr(r, key)[f] for f in range(F)]
                     for r in results])


def _grid_vs_scalar(case):
    scens = CASES[case](PORT)
    out = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    return scens, out, _runs(case, PORT)


def test_float64_grid_equals_scalar_incast8():
    scens, out, res = _grid_vs_scalar("incast8")
    F = len(scens[0].flows)
    assert rel(out["flow_goodput_gbps"],
               _stack(res, "flow_goodput_gbps", F)) <= 1e-9
    assert np.array_equal(out["flow_completion_us"],
                          _stack(res, "flow_completion_us", F))
    assert rel(out["incast_completion_us"],
               [r.incast_completion_us for r in res]) == 0.0
    assert rel(out["victim_goodput_gbps"],
               [r.victim_goodput_gbps for r in res]) <= 1e-9
    assert np.array_equal(out["pause_fanout"], [r.pause_fanout for r in res])
    for key in ("ecn_marked_bytes", "switch_dropped_bytes"):
        assert rel(out[key], [getattr(r, key) for r in res]) <= 1e-9, key


def test_float64_grid_equals_scalar_messages():
    scens, out, res = _grid_vs_scalar("message_incast")
    F = len(scens[0].flows)
    assert out["has_messages"].all()
    counts = np.array([[len(r.msg_latency_us.get(f, [])) for f in range(F)]
                       for r in res])
    assert np.array_equal(out["msg_count"], counts)
    last = np.array([[r.msg_last_done_us.get(f, 0.0) for f in range(F)]
                     for r in res])
    np.testing.assert_allclose(out["msg_last_done_us"], last, atol=1e-9)
    assert rel(out["flow_goodput_gbps"],
               _stack(res, "flow_goodput_gbps", F)) <= 1e-9


def test_float64_grid_equals_scalar_faults():
    scens, out, res = _grid_vs_scalar("lossy_incast")
    F = len(scens[0].flows)
    for key in ("dropped_pkts", "retransmit_bytes"):
        assert rel(out[key], [getattr(r, key) for r in res]) <= 1e-9, key
    counts = np.array([[len(r.msg_latency_us.get(f, [])) for f in range(F)]
                       for r in res])
    assert np.array_equal(out["msg_count"], counts)
    assert rel(out["flow_goodput_gbps"],
               _stack(res, "flow_goodput_gbps", F)) <= 1e-9


# --------------------------------------------------------------------------- #
# the ValueErrors of run_fabric
# --------------------------------------------------------------------------- #
def _host_tc_legacy_switch(M):
    s = M["SC"].incast(n_senders=2, burst_mb=0.1, sim_time_s=0.0001)
    s.fabric.switch = M["SW"].SwitchConfig(per_tc=False)
    s.fabric.receiver_cfg = lambda h: M["S"].testbed_25g(
        "ddio", host_pfc_per_tc=True)
    return s


def _dyn_two_sspines(M):
    topo = M["T"].make_pod_clos(2, 2, 1, sspines_per_plane=2)
    flows = [M["FB"].Flow(src="p0h0_0", dst="p1h1_0")]
    fc = M["FB"].FabricConfig(
        sim_time_s=0.0001,
        routing=M["SC"].RoutingConfig(mode="adaptive"))
    return M["SC"].Scenario("dyn", topo, flows, fc)


def _crash_non_receiver(M):
    s = M["SC"].lossy_incast(n_senders=2, sim_time_s=0.0001)
    s.fabric.faults = M["F"].FaultConfig(0.0).crash("h0_0", 10.0, 20.0)
    return s


def _loop_flow(M):
    s = M["SC"].incast(n_senders=2, burst_mb=0.1, sim_time_s=0.0001)
    s.flows = s.flows + [M["FB"].Flow(src="h0_0", dst="h0_0")]
    return s


ERRORS = {"host_pfc_per_tc_legacy_switch": _host_tc_legacy_switch,
          "dynamic_routing_two_sspines": _dyn_two_sspines,
          "crash_on_non_receiver": _crash_non_receiver,
          "flow_to_itself": _loop_flow}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_run_fabric_value_errors_match_reference(case):
    msgs = []
    for M in (PORT, REF):
        with pytest.raises(ValueError) as e:
            ERRORS[case](M).run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if case == "host_pfc_per_tc_legacy_switch":
        assert msgs[0] == "host_pfc_per_tc requires SwitchConfig.per_tc"


def test_grid_entry_points_still_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(Exception, match="CUDA"):
        run_fabric_sweep(CASES["single_pair"](PORT))
