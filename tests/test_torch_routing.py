"""The port's dense tick under dynamic routing, link failures and flaps,
WRR scheduling and per-TC host PFC, against the reference's engine.

Both packages build each grid from the same arguments:

* a ``routing_grid`` (all four modes x {no failure, an uplink failure
  mid-burst}), a periodic link flap under adaptive and static routing,
  the OLAP shuffle under static and weighted ECMP, spray with a settle
  time of 0 and 40 us, the strict/WRR pair of ``tests/test_routing.py``
  (``test_wrr_prevents_low_starvation_on_saturated_port``), its host-gate
  pair (``test_host_per_tc_pfc_isolates_classes_on_access_link``) and
  ``qos_mixed_grid`` (legacy vs per-TC pause);
* float64 on the CPU vs ``backend="numpy"`` (float64): <= 1e-9 relative
  on every output, ``reroute_count``, ``pause_fanout`` and
  ``pause_tc_fanout`` exact;
* float32 on the CPU vs ``backend="jax", impl="ref"`` (float32): <= 5e-4
  relative, the ``dev_goodput_vs_numpy`` ceiling of
  ``benchmarks/bench_floors.json``, reroute counts exact;
* identical finite masks throughout.

Depths are cut to what each case needs to exercise its branch (the
failure, flap and settle times sit inside the window).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.simulator as RS
import repro.fabric.routing as RR
import repro.fabric.scenarios as RSC
import repro.fabric.topology as RT
from repro.core.datapath import QoS as RQoS
from repro.fabric.fabric import FabricConfig as RFabricConfig
from repro.fabric.fabric import Flow as RFlow
from repro.fabric.switch import SwitchConfig as RSwitchConfig
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
import repro_torch.core.simulator as TS
import repro_torch.fabric.routing as TR
import repro_torch.fabric.scenarios as TSC
import repro_torch.fabric.topology as TT
from repro_torch.fabric.fabric import FabricConfig as TFabricConfig
from repro_torch.fabric.fabric import Flow as TFlow
from repro_torch.fabric.switch import SwitchConfig as TSwitchConfig
from repro_torch.fabric import vector as TV
from repro_torch.fabric.vector import (FabricSweepParams, run_fabric_sweep,
                                       run_packed)

torch.set_num_threads(1)

REF = dict(SC=RSC, R=RR)
PORT = dict(SC=TSC, R=TR)

F32 = ["flow_goodput_gbps", "flow_delivered_bytes", "flow_completion_us",
       "incast_completion_us", "victim_goodput_gbps", "recv_goodput_gbps",
       "pause_total_us", "uplink_util_max"]
EXACT = ["reroute_count", "flow_reroutes", "pause_fanout",
         "pause_tc_fanout", "n_pausable_links", "has_victim"]


def _routing(M):
    return M["SC"].routing_grid(
        modes=("static_ecmp", "weighted_ecmp", "adaptive", "spray"),
        fail_at_us=(math.inf, 50.0), burst_mb=1.0, n_senders=4,
        sim_time_s=0.0004)[0]


def _flap(M):
    out = []
    for routing in ("adaptive", "static_ecmp"):
        s = M["SC"].link_failure_incast(
            n_senders=4, routing=routing, burst_mb=0.5,
            fail_at_us=math.inf, sim_time_s=0.0003)
        s.topology.flap_link("leaf0", "spine1", start_us=40.0,
                             period_us=100.0, down_us=30.0)
        out.append(s)
    return out


def _shuffle(M):
    return [M["SC"].olap_shuffle(n_mappers=3, n_reducers=2,
                                 shuffle_mb=0.6, routing=r,
                                 sim_time_s=0.0003)
            for r in ("static_ecmp", "weighted_ecmp")]


def _spray(M):
    out = []
    for settle in (0.0, 40.0):
        s = M["SC"].link_failure_incast(
            n_senders=4, routing="spray", burst_mb=0.5,
            fail_at_us=math.inf, sim_time_s=0.0003)
        s.fabric.routing = M["R"].RoutingConfig(mode="spray",
                                                spray_settle_us=settle)
        out.append(s)
    return out


def _wrr_pair(M, sim_time_s=0.0005):
    """The port's ``scenarios.wrr_pair``; the reference has no builder
    of its own, so its twin is built here from the same arguments: 3
    HIGH senders saturate one 100G downlink that a LOW flow shares."""
    if M is PORT:
        return TSC.wrr_pair(sim_time_s)
    topo = RT.incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [RFlow(src=f"h0_{i}", dst="h1_0", offered_gbps=60.0,
                   qos=RQoS.HIGH, tag="hi") for i in range(3)]
    flows.append(RFlow(src="h0_3", dst="h1_0", offered_gbps=40.0,
                       qos=RQoS.LOW, tag="low"))
    out = []
    for sched in ("strict", "wrr"):
        sw = RSwitchConfig(pfc_enabled=False, ecn_enabled=False,
                           scheduler=sched, port_buffer_bytes=1 << 20)
        fc = RFabricConfig(sim_time_s=sim_time_s, switch=sw,
                           receiver_cfg=lambda h: RS.testbed_100g("ddio"))
        out.append(RSC.Scenario(name=sched, topology=topo, flows=flows,
                                fabric=fc))
    return out


def _host_pair(M, sim_time_s=0.0006):
    """The port's ``scenarios.host_gate_pair``, and its reference twin:
    a LOW bulk incast fills the receiver's RNIC buffer beside a 1 Gbps
    HIGH flow under the whole-link and the per-class gate."""
    if M is PORT:
        return TSC.host_gate_pair(sim_time_s)
    topo = RT.incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [RFlow(src=f"h0_{i}", dst="h1_0", qos=RQoS.LOW, tag="bulk")
             for i in range(3)]
    flows.append(RFlow(src="h0_3", dst="h1_0", offered_gbps=1.0,
                       qos=RQoS.HIGH, tag="hi"))
    out = []
    for per_tc in (False, True):
        def recv(host, per_tc=per_tc):
            return RS.testbed_100g("ddio", pfc_enabled=True,
                                   host_pfc_per_tc=per_tc,
                                   rnic_ecn_cnp=False, cpu_membw_gbps=1995.0)
        fc = RFabricConfig(sim_time_s=sim_time_s,
                           switch=RSwitchConfig(pfc_enabled=True),
                           receiver_cfg=recv)
        out.append(RSC.Scenario(name=f"htc{per_tc}", topology=topo,
                                flows=flows, fabric=fc))
    return out


def _qos(M):
    return M["SC"].qos_mixed_grid(per_tc=(False, True),
                                  sim_time_s=0.0005)[0]


CASES = {"routing_grid": _routing, "flap": _flap, "shuffle": _shuffle,
         "spray_settle": _spray, "wrr": _wrr_pair, "host_gate": _host_pair,
         "qos_mixed": _qos}

_RUNS = {}


def _run(kind, case):
    key = (kind, case)
    if key not in _RUNS:
        if kind == "numpy":
            out = ref_sweep(CASES[case](REF), backend="numpy")
        elif kind == "jax":
            out = ref_sweep(CASES[case](REF), backend="jax", impl="ref")
        else:
            dt = torch.float64 if kind == "port64" else torch.float32
            out = run_fabric_sweep(CASES[case](PORT), device="cpu",
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_matches_numpy_reference(case):
    got, want = _run("port64", case), _run("numpy", case)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if want[k].dtype == bool or k in EXACT:
            assert np.array_equal(got[k], want[k]), k
        else:
            assert rel(got[k], want[k]) <= 1e-9, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_float32_matches_jax_reference(case):
    got, want = _run("port32", case), _run("jax", case)
    for k in F32:
        if k in want:
            assert rel(got[k], want[k]) <= 5e-4, k
    for k in EXACT:
        if k in want:
            assert np.array_equal(got[k], want[k]), k


def test_cases_exercise_their_branches():
    """The comparison grids are not vacuous."""
    r = _run("numpy", "routing_grid")
    fct = r["incast_completion_us"]
    # points: fail_at (inf, 50) x mode (static, weighted, adaptive, spray)
    assert np.isfinite(fct[:4]).all()
    assert not np.isfinite(fct[4])                  # static stalls
    assert np.isfinite(fct[5:]).all()               # the others reroute
    assert r["reroute_count"][6] > 0 and r["reroute_count"][4] == 0
    assert (r["uplink_util_max"] > 0).all()
    assert _run("numpy", "flap")["reroute_count"][0] > 0
    assert _run("numpy", "shuffle")["reroute_count"][1] > 0
    sp = _run("numpy", "spray_settle")["incast_completion_us"]
    assert sp[1] >= sp[0] + 30.0
    low = _run("numpy", "wrr")["flow_goodput_gbps"][:, 3]
    assert low[1] > 10.0 * max(low[0], 1e-3)
    hg = _run("numpy", "host_gate")
    assert (hg["recv_pfc_pause_us"] > 0).all()
    assert hg["flow_goodput_gbps"][1, 3] > hg["flow_goodput_gbps"][0, 3]
    q = _run("numpy", "qos_mixed")
    assert (q["pause_fanout"] > 0).all()


def test_runs_on_the_reference_packing():
    """Fed the reference's packing of a dynamic grid (``from_arrays``),
    the port reproduces its run on its own packing exactly."""
    ref = RefParams.from_scenarios(_flap(REF) + _flap(REF)[:1])
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fsp = FabricSweepParams.from_arrays(d)
    assert fsp.dyn_route and fsp.any_flap and fsp.n_spines == 2
    a = run_packed(fsp, device="cpu", dtype=torch.float64)
    b = run_fabric_sweep(_flap(PORT) + _flap(PORT)[:1], device="cpu",
                         dtype=torch.float64)
    for k in b:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


@pytest.mark.parametrize("case", ["routing_grid", "wrr", "host_gate",
                                  "spray_settle"])
def test_packing_matches_reference(case):
    ref = RefParams.from_scenarios(CASES[case](REF))
    port = FabricSweepParams.from_scenarios(CASES[case](PORT))
    for name in ("port_keys", "recv_hosts", "flow_tags", "n_points",
                 "n_flows", "n_ports", "n_recv", "ticks", "dt_us",
                 "ring_len", "cnp_ring", "dyn_route", "any_wrr", "host_tc",
                 "settle_ring", "n_spines", "any_flap"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("stage_mask", "recv_onehot", "recv_of", "qos_of",
                 "prev_onehot", "owner_recv", "upP", "dnP", "candS",
                 "crossF", "T1", "init_spine"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert sorted(port.pvals) == sorted(ref.pvals)
    for k, v in ref.pvals.items():
        assert port.pvals[k].dtype == v.dtype, k
        assert np.array_equal(port.pvals[k], v), k


def test_dynamic_grid_structure_checks():
    a = TSC.link_failure_incast(n_senders=2, sim_time_s=0.0002)
    b = TSC.link_failure_incast(n_senders=4, sim_time_s=0.0002)
    with pytest.raises(ValueError):               # flow sets differ
        FabricSweepParams.from_scenarios([a, b])
    c = TSC.link_failure_incast(n_senders=2, sim_time_s=0.0002,
                                uplink_gbps=200.0)
    fsp = FabricSweepParams.from_scenarios([a, c])
    assert fsp.dyn_route and fsp.n_spines == 2
    d = TSC.link_failure_incast(n_senders=2, sim_time_s=0.0002)
    d.topology = TT.clos(n_leaves=2, hosts_per_leaf=2, n_spines=3)
    with pytest.raises(ValueError, match="structure"):
        FabricSweepParams.from_scenarios([a, d])
    static = FabricSweepParams.from_scenarios(
        [TSC.incast(n_senders=2, sim_time_s=0.0002)])
    assert not static.dyn_route and static.init_spine is None


def test_host_per_tc_requires_classed_switch():
    topo = TT.incast_fabric(2)
    flows = [TFlow(src="h0_0", dst="h1_0")]
    fc = TFabricConfig(sim_time_s=0.0001,
                       switch=TSwitchConfig(pfc_enabled=True, per_tc=False),
                       receiver_cfg=lambda h: TS.testbed_100g(
                           "ddio", pfc_enabled=True, host_pfc_per_tc=True))
    sc = TSC.Scenario(name="bad", topology=topo, flows=flows, fabric=fc)
    with pytest.raises(ValueError, match="per_tc"):
        FabricSweepParams.from_scenarios([sc])


# --------------------------------------------------------------------------- #
# topology schedules and routing helpers
# --------------------------------------------------------------------------- #
def test_fail_link_schedule_and_validation():
    topo = TT.incast_fabric(2)
    topo.fail_link("leaf0", "spine0", at_us=100.0, restore_us=200.0)
    assert topo.link_down[("leaf0", "spine0")] == (100.0, 200.0)
    assert topo.link_down[("spine0", "leaf0")] == (100.0, 200.0)
    assert topo.link_up_at(("leaf0", "spine0"), 99.0)
    assert not topo.link_up_at(("leaf0", "spine0"), 100.0)
    assert topo.link_up_at(("leaf0", "spine0"), 200.0)
    assert topo.failure_ticks(1.0)[("leaf0", "spine0")] == (100, 200)
    topo.fail_link("leaf0", "spine1", at_us=50.0)
    assert topo.failure_ticks(1.0)[("leaf0", "spine1")] == \
        (50, TT.NEVER_TICK)
    topo.validate()
    with pytest.raises(ValueError):
        topo.fail_link("leaf0", "nope", at_us=1.0)
    with pytest.raises(ValueError):
        topo.fail_link("leaf0", "spine0", at_us=5.0, restore_us=5.0)
    assert topo.candidate_spines("h0_0", "h1_0") == ["spine0", "spine1"]
    assert topo.candidate_spines("h0_0", "h0_1") == []
    topo.link_down[("leaf0", "ghost")] = (1.0, 2.0)
    with pytest.raises(ValueError, match="unknown link"):
        topo.validate()


def test_flap_schedule_matches_reference():
    args = [(0.0, 10.0, 3.0), (40.0, 100.0, 30.0), (7.4, 2.2, 0.4),
            (5.0, 3.0, 2.9)]
    for start, period, down in args:
        a, b = TT.incast_fabric(2), RT.incast_fabric(2)
        a.flap_link("spine1", "leaf1", start, period, down)
        b.flap_link("spine1", "leaf1", start, period, down)
        assert a.link_flaps == b.link_flaps
        for dt in (1.0, 0.5, 2.0):
            assert a.flap_ticks(dt) == b.flap_ticks(dt)
        for now in np.linspace(0.0, 250.0, 501):
            for key in (("spine1", "leaf1"), ("leaf1", "spine1"),
                        ("leaf0", "spine0")):
                assert a.link_up_at(key, now) == b.link_up_at(key, now)
    topo = TT.incast_fabric(2)
    with pytest.raises(ValueError):
        topo.flap_link("leaf0", "spine0", 0.0, 10.0, 10.0)
    with pytest.raises(ValueError):
        topo.flap_link("leaf0", "nope", 0.0, 10.0, 1.0)
    topo.link_flaps[("ghost", "leaf0")] = (0.0, 10.0, 1.0)
    with pytest.raises(ValueError, match="unknown link"):
        topo.validate()


def test_candidate_paths_and_uplinks_match_reference():
    a, b = TT.clos(3, 2, 3), RT.clos(3, 2, 3)
    for src in a.hosts:
        for dst in a.hosts:
            if src != dst:
                assert a.candidate_paths(src, dst) == \
                    b.candidate_paths(src, dst)
    for leaf in a.leaves:
        assert a.uplinks(leaf) == [TT.Link(l.src, l.dst, l.gbps)
                                   for l in b.uplinks(leaf)]


def test_routing_helpers_match_reference():
    rng = np.random.default_rng(19)
    for _ in range(400):
        n = int(rng.integers(1, 6))
        w = rng.uniform(0.0, 1e6, n) * (rng.random(n) < 0.8)
        if w.sum() <= 0.0:
            w[0] = 1.0
        h = float(rng.random())
        assert TR.weighted_pick(list(w), h) == RR.weighted_pick(list(w), h)
        occ = list(rng.uniform(0.0, 1e6, n))
        up = list(rng.random(n) < 0.7)
        cur = int(rng.integers(0, n))
        hyst = float(rng.uniform(0.0, 2e5))
        assert TR.adaptive_pick(occ, up, cur, hyst) == \
            RR.adaptive_pick(occ, up, cur, hyst)
        assert TR.spray_weights(occ, up, 1e6, cur) == \
            RR.spray_weights(occ, up, 1e6, cur)
        fid, k = int(rng.integers(0, 1 << 12)), int(rng.integers(0, 1 << 16))
        assert TR.flowlet_hash(fid, k) == RR.flowlet_hash(fid, k)
    for mode in TR.ROUTING_MODES:
        assert TR.RoutingConfig(mode=mode).mode_code() == \
            RR.RoutingConfig(mode=mode).mode_code()


def test_wrr_quanta_resolve_as_reference():
    for q in (None, (1.0, 1.0, 1.0), (8, 3, 1)):
        assert TSwitchConfig(scheduler="wrr", wrr_quanta=q).quanta() == \
            RSwitchConfig(scheduler="wrr", wrr_quanta=q).quanta()
    assert TSwitchConfig().quanta() == (4.0, 2.0, 1.0)


# --------------------------------------------------------------------------- #
# the tick's stacked link state and spine choice against the scalar
# helpers above (Topology.link_up_at, routing.*_pick / spray_weights)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt_us", [1.0, 0.5])
def test_tick_link_state_is_link_up_at(dt_us):
    """Each tick's down mask is ``not link_up_at`` of every port at that
    tick's time, and the falling-edge mask fires exactly where a link
    goes from up to down (failure windows and flaps, on two points)."""
    grid = []
    for restore in (math.inf, 120.0):
        s = TSC.link_failure_incast(n_senders=2, fail_at_us=30.0,
                                    restore_us=restore, sim_time_s=0.0002)
        s.topology.flap_link("leaf0", "spine1", start_us=11.0,
                             period_us=40.0, down_us=9.0)
        s.fabric.dt_us = dt_us
        grid.append(s)
    fsp = FabricSweepParams.from_scenarios(grid)
    assert fsp.any_flap and fsp.ticks == int(200 / dt_us)
    p = {k: TV._to_device(v, torch.float64, torch.device("cpu"))
         for k, v in TV._np_params(fsp, np.float64).items()}
    was_up = np.ones((len(grid), fsp.n_ports), bool)
    n_edges = 0
    for t in range(fsp.ticks):
        down, edge = (x.numpy() for x in TV.link_state(t, p, True))
        up = np.array([[s.topology.link_up_at(k, t * dt_us)
                        for k in fsp.port_keys] for s in grid])
        assert np.array_equal(down, ~up), t
        assert np.array_equal(edge, was_up & ~up), t
        n_edges += int(edge.sum())
        was_up = up
    assert n_edges > 10


@pytest.mark.parametrize("case", ["routing_grid", "shuffle"])
def test_candidate_ports_follow_candidate_paths(case):
    """Candidate s of a cross-leaf flow is the s-th path of
    ``Topology.candidate_paths``: its uplink and downlink ports, and the
    uplink ports are the source leaves' ``uplinks``."""
    scens = CASES[case](PORT)
    fsp = FabricSweepParams.from_scenarios(scens)
    topo = scens[0].topology
    keys = fsp.port_keys
    src_leaves = set()
    for fid, f in enumerate(scens[0].flows):
        paths = topo.candidate_paths(f.src, f.dst)
        assert bool(fsp.crossF[fid]) == bool(paths)
        assert fsp.candS[:, fid].sum() == len(paths)
        for si, (sl, spine, dl) in enumerate(paths):
            src_leaves.add(sl)
            assert keys[int(fsp.upP[si, fid].argmax())] == (sl, spine)
            assert keys[int(fsp.dnP[si, fid].argmax())] == (spine, dl)
    assert {k for k, on in zip(keys, fsp.stage_mask[1]) if on} == \
        {(l.src, l.dst) for leaf in src_leaves for l in topo.uplinks(leaf)}


@pytest.mark.parametrize("n_spines", [1, 2, 3, 4])
def test_tick_spine_choice_is_the_scalar_helpers(n_spines):
    """On seeded [G, S, F] queues, up masks (all-down columns, ties) and
    flowlet indices, in float64: the tick's adaptive choice is
    ``adaptive_pick``, its weighted pick ``weighted_pick`` of the
    free-space weights at ``flowlet_hash``, its spray split
    ``spray_weights``, for every (point, flow)."""
    rng = np.random.default_rng(40 + n_spines)
    G, S, F, buf = 6, n_spines, 40, 1e6
    one, zero = torch.tensor(1.0, dtype=torch.float64), \
        torch.tensor(0.0, dtype=torch.float64)
    inf, tiny = torch.tensor(math.inf, dtype=torch.float64), \
        torch.tensor(1e-30, dtype=torch.float64)
    occ = np.round(rng.uniform(0.0, 1.3 * buf, (G, S, F)), -5)  # ties
    up = rng.random((G, S, F)) < 0.7
    up[:, :, 0] = False                                  # all down
    cur = rng.integers(0, S, (G, F)).astype(np.int32)
    k = rng.integers(0, 1 << 20, (G, F)).astype(np.int32)
    hyst = np.float64(0.05 * buf)
    occS, upS = torch.from_numpy(occ), torch.from_numpy(up)
    curT = torch.from_numpy(cur)
    cur_oh = torch.arange(S, dtype=torch.int32)[:, None] == curT[:, None, :]
    up_cur = (upS & cur_oh).any(-2)
    free = torch.where(upS, torch.maximum(buf - occS, zero), zero)
    adapt = TV.adaptive_choice(occS, upS, curT, cur_oh, up_cur,
                               torch.tensor(hyst), one, zero, inf)
    fid = torch.arange(F, dtype=torch.int32)
    hsh = TV.flowlet_hashes(fid, torch.from_numpy(k),
                            torch.tensor(65536.0, dtype=torch.float64))
    pick, tot = TV.weighted_choice(free, hsh, one, zero)
    ch_oh = torch.where(cur_oh, one, zero)
    spray = TV.spray_split(free, tot, ch_oh, zero, tiny)
    n_weighted = 0
    for g in range(G):
        for f in range(F):
            o, u, c = list(occ[g, :, f]), list(up[g, :, f]), int(cur[g, f])
            assert adapt[g, f] == TR.adaptive_pick(o, u, c, float(hyst))
            h = TR.flowlet_hash(f, int(k[g, f]) % 65536)
            assert hsh[g, f] == h
            w = list(free[g, :, f].numpy())
            if sum(w) > 0.0:
                assert pick[g, f] == TR.weighted_pick(w, h)
                n_weighted += 1
            assert spray[g, :, f].tolist() == \
                TR.spray_weights(o, u, buf, c)
    assert n_weighted > G * F // 4
