"""Pod-scale (3-level Clos) fabrics in the port against the reference:
the topology (``make_pod_clos``, the super-spine tier, candidate paths
and static ECMP routes), the pod scenarios, their sparse packing, and
the sparse-incidence engine end to end, on the CPU.

* topology: nodes, links, rates, pods and super-spines equal the
  reference's at several sizes (``pods=1`` included); candidate paths
  and routes of every host pair equal; per-tier oversubscription, bad
  sizes and unroutable pairs behave as the reference's;
* every pod scenario packs (``sparse=True``) field for field as the
  reference's, under a failure and a flap schedule too (``pack_fail``,
  ``pause_extra``, ``pausable_extra``);
* float64 on the CPU equals the reference's ``numpy`` backend (float64,
  ``np.add.at`` segment sums) within 1e-9 with counts exact: pod incast,
  a failure and a flap under per-TC PFC
  (``tests/test_topology_pods.py:_fail_tc_scenario``), the pod shuffle
  across the super-spine tier, the pod PFC storm, and the CC zoo grid of
  ``tests/test_sparse_cc.py`` under ``incidence="sparse"``;
* float32 on the CPU within 5e-4 of the reference's ``jax`` backend
  (float32), the tier of ``tests/test_topology_pods.py``;
* on 2-tier grids the sparse engine equals the dense one in float64;
* the refusals (dense on a super-spine fabric; sparse with dynamic
  routing, messages, faults or adaptive dt) raise as the reference's;
* the static-buffer chain equals the eager loop on a pod grid, and the
  step takes a tensor tick;
* the engine's footprint (state, statics, plans) grows with flows x
  hops: exponent ~0.8 from 64 to 256 hosts, the ``scale`` ceiling 1.6.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core.datapath import QoS as RQoS
from repro.fabric import fabric as RF
from repro.fabric import scenarios as SC
from repro.fabric import switch as RSW
from repro.fabric import topology as RT
from repro.fabric.cc import CcConfig as RCc
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
from repro_torch.core.datapath import QoS as TQoS
from repro_torch.fabric import FaultConfig, MessageConfig, RoutingConfig
from repro_torch.fabric import fabric as TF
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric import fused
from repro_torch.fabric import switch as TSW
from repro_torch.fabric import topology as TT
from repro_torch.fabric import vector as TV
from repro_torch.fabric.cc import CcConfig as TCc
from repro_torch.fabric.vector import (FabricRun, FabricSweepParams,
                                       run_fabric_sweep)

torch.set_num_threads(1)

PORT = dict(T=TT, SC=TSC, F=TF, SW=TSW, QoS=TQoS, Cc=TCc)
REF = dict(T=RT, SC=SC, F=RF, SW=RSW, QoS=RQoS, Cc=RCc)
SIZES = [(1, 2, 2, {}), (2, 2, 2, {}), (3, 2, 3, {}),
         (2, 3, 2, {"spines_per_pod": 3, "sspines_per_plane": 2}),
         (4, 4, 16, {"host_gbps": 200.0})]
EXACT = ("pause_fanout", "pause_tc_fanout", "n_pausable_links",
         "recv_cnp_count", "has_victim", "has_messages")


def _ids(sizes):
    return ["x".join(map(str, s[:3])) + ("+" if s[3] else "")
            for s in sizes]


def rel(a, b) -> float:
    """Max relative deviation; inf when the finite masks differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return math.inf
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


def _held(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in EXACT:
            assert np.array_equal(got[k], want[k]), k
        else:
            assert rel(got[k], want[k]) <= tol, k


# --------------------------------------------------------------------------- #
# Topology
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size", SIZES, ids=_ids(SIZES))
def test_make_pod_clos_equals_reference(size):
    pods, lpp, hpl, kw = size
    a, b = TT.make_pod_clos(pods, lpp, hpl, **kw), \
        RT.make_pod_clos(pods, lpp, hpl, **kw)
    for name in ("hosts", "leaves", "spines", "super_spines", "host_leaf",
                 "pod_of"):
        assert getattr(a, name) == getattr(b, name), name
    assert {k: v.gbps for k, v in a.links.items()} \
        == {k: v.gbps for k, v in b.links.items()}
    assert bool(a.super_spines) == (pods > 1)


@pytest.mark.parametrize("size", [(2, 2, 2), (3, 2, 3)],
                         ids=["2x2x2", "3x2x3"])
def test_paths_and_routes_equal_reference(size):
    a, b = TT.make_pod_clos(*size), RT.make_pod_clos(*size)
    for src in a.hosts:
        for dst in a.hosts:
            if src == dst:
                continue
            assert a.candidate_paths(src, dst) == \
                b.candidate_paths(src, dst)
            assert a.candidate_spines(src, dst) == \
                b.candidate_spines(src, dst)
            for fid in range(5):
                r = a.route(src, dst, fid)
                assert r == b.route(src, dst, fid)
                assert [l.key for l in a.route_links(src, dst, fid)] == \
                    [l.key for l in b.route_links(src, dst, fid)]
                if len(r) == 7:
                    # cross-pod: plane-aligned through a super-spine
                    assert r[3] in a.super_spines
                    assert r[2][-1] == r[3][-1] == r[4][-1]


def test_two_tier_route_is_the_spine_hash():
    """On a fully wired 2-tier Clos the path hash is the old spine pick
    ``spines[flow_id % n]``."""
    t = TT.clos(n_leaves=3, hosts_per_leaf=2, n_spines=3)
    for fid in range(7):
        assert t.route("h0_0", "h2_1", fid) == \
            ["h0_0", "leaf0", t.spines[fid % 3], "leaf2", "h2_1"]
        assert t.route("h0_0", "h0_1", fid) == ["h0_0", "leaf0", "h0_1"]


def test_tier_queries_equal_reference():
    kw = dict(spines_per_pod=2, host_gbps=100.0, leaf_spine_gbps=150.0,
              spine_sspine_gbps=250.0)
    a, b = TT.make_pod_clos(3, 2, 4, **kw), RT.make_pod_clos(3, 2, 4, **kw)
    for leaf in a.leaves:
        assert a.oversubscription(leaf) == b.oversubscription(leaf)
        assert a.hosts_on(leaf) == b.hosts_on(leaf)
    for sp in a.spines:
        assert a.spine_oversubscription(sp) == b.spine_oversubscription(sp)
        assert [l.key for l in a.super_uplinks(sp)] == \
            [l.key for l in b.super_uplinks(sp)]
    assert a.bisection_gbps() == b.bisection_gbps()
    assert [l.key for l in a.fabric_uplinks()] == \
        [l.key for l in b.fabric_uplinks()]
    t2 = TT.clos(2, 4, 2)
    assert t2.spine_oversubscription("spine0") == math.inf
    assert t2.fabric_uplinks() == [l for lf in t2.leaves
                                   for l in t2.uplinks(lf)]


def _partial(M, rescue_spine: bool):
    """2 leaves whose local spines do not interconnect them; with
    ``rescue_spine`` a third spine wires to both
    (``tests/test_topology_pods.py:TestPartialWiring``)."""
    links = {}
    for a, b_, g in (("a0", "l0", 100.0), ("b0", "l1", 100.0),
                     ("l0", "s0", 200.0), ("l1", "s1", 200.0)):
        M._bidi(links, a, b_, g)
    spines = ["s0", "s1"]
    if rescue_spine:
        M._bidi(links, "l0", "s2", 200.0)
        M._bidi(links, "l1", "s2", 200.0)
        spines.append("s2")
    t = M.Topology(hosts=["a0", "b0"], leaves=["l0", "l1"], spines=spines,
                   links=links, host_leaf={"a0": "l0", "b0": "l1"})
    t.validate()
    return t


@pytest.mark.parametrize("M", [TT, RT], ids=["port", "reference"])
def test_bad_sizes_unroutable_pairs_and_tiers_raise(M):
    for dims in ((0, 2, 2), (2, 0, 2), (2, 2, 0)):
        with pytest.raises(ValueError, match="pod-Clos"):
            M.make_pod_clos(*dims)
    with pytest.raises(ValueError, match="pod-Clos"):
        M.make_pod_clos(2, 2, 2, sspines_per_plane=0)
    t = _partial(M, False)
    assert t.candidate_spines("a0", "b0") == []
    with pytest.raises(ValueError, match="unroutable"):
        t.route("a0", "b0", 0)
    with pytest.raises(ValueError, match="unroutable"):
        t.candidate_paths("a0", "b0")
    assert _partial(M, True).route("a0", "b0", 5) == \
        ["a0", "l0", "s2", "l1", "b0"]
    # a super-spine wired to no spine, and super-spines with no spines
    pod = M.make_pod_clos(2, 2, 2)
    bad = dataclasses.replace(pod, super_spines=pod.super_spines + ["ssX"])
    M._bidi(bad.links, "ssX", "p0l0", 10.0)
    with pytest.raises(ValueError, match="super-spine ssX"):
        bad.validate()
    one = M.make_pod_clos(1, 1, 2)
    lone = dataclasses.replace(one, spines=[], super_spines=["ss0"],
                               links={k: v for k, v in one.links.items()
                                      if "p0s" not in k[0] + k[1]})
    M._bidi(lone.links, "ss0", "p0l0", 10.0)
    with pytest.raises(ValueError, match="super-spine"):
        lone.validate()


# --------------------------------------------------------------------------- #
# Scenarios and packing
# --------------------------------------------------------------------------- #
def _fail_tc(M, flap: bool = False, sim_time_s: float = 0.0015):
    """``tests/test_topology_pods.py:_fail_tc_scenario`` from either
    package: cross-pod incast, a victim and a low-priority flow under
    per-TC PFC, a leaf uplink down 300-1200 us, optionally a flap on a
    second uplink."""
    topo = M["T"].make_pod_clos(2, 2, 2)
    topo.fail_link("p0l0", "p0s0", at_us=300.0, restore_us=1200.0)
    if flap:
        topo.flap_link("p1l0", "p1s0", start_us=200.0, period_us=400.0,
                       down_us=150.0)
    Flow, QoS = M["F"].Flow, M["QoS"]
    flows = [Flow(src=f"p1h{li}_{hi}", dst="p0h0_0", burst_bytes=2e5,
                  qos=QoS.NORMAL, tag="incast")
             for li in range(2) for hi in range(2)]
    flows.append(Flow(src="p0h1_0", dst="p0h0_1", tag="victim"))
    flows.append(Flow(src="p1h0_1", dst="p0h1_1", qos=QoS.LOW))
    fab = M["F"].FabricConfig(
        sim_time_s=sim_time_s,
        switch=M["SW"].SwitchConfig(pfc_enabled=True, per_tc=True),
        receiver_cfg=M["SC"]._recv_factory("ddio", True))
    return M["SC"].Scenario(name="pod_fail_tc" + ("_flap" if flap else ""),
                            topology=topo, flows=flows, fabric=fab)


def _cc_grid(M):
    """``tests/test_sparse_cc.py:_cc_mixed_grid``: 2-tier incast racing
    the CC zoo, algo x PFC a point."""
    scens = []
    for algo in ("dcqcn", "timely", "hpcc"):
        for pfc in (False, True):
            sc = M["SC"].incast(n_senders=4, mode="ddio", pfc=pfc,
                                burst_mb=0.5, sim_time_s=0.001)
            sc.fabric.cc = M["Cc"](algo=algo)
            scens.append(sc)
    return scens


SIM_S = 0.001
SCENARIOS = {
    "pod_incast": lambda M: [M["SC"].pod_incast(sim_time_s=SIM_S)],
    "pod_incast_grid": lambda M: M["SC"].pod_incast_grid(
        pods=2, leaves_per_pod=2, hosts_per_leaf=2, burst_mb=0.2,
        sim_time_s=SIM_S)[0],
    "pod_shuffle": lambda M: [M["SC"].pod_shuffle(
        pods=2, leaves_per_pod=2, hosts_per_leaf=2, shuffle_mb=0.2,
        sim_time_s=SIM_S)],
    "pod_pfc_storm": lambda M: [M["SC"].pod_pfc_storm(
        pods=3, hosts_per_leaf=2, per_tc=False, sim_time_s=SIM_S)],
    "pod_storm_grid": lambda M: M["SC"].pod_storm_grid(sim_time_s=SIM_S)[0],
    "fail_tc": lambda M: [_fail_tc(M)],
    "fail_tc_flap": lambda M: [_fail_tc(M, flap=True)],
}


def _fields(port, ref):
    for f in dataclasses.fields(FabricSweepParams):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "pvals":
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b) and all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(a, b)), f.name
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", SCENARIOS)
def test_pod_scenarios_pack_as_the_reference(name):
    tp, rf = SCENARIOS[name](PORT), SCENARIOS[name](REF)
    assert [s.name for s in tp] == [s.name for s in rf]
    port = FabricSweepParams.from_scenarios(tp, sparse=True)
    ref = RefParams.from_scenarios(rf, sparse=True)
    _fields(port, ref)
    assert port.sparse and port.pack_fail == name.startswith("fail")
    if name.startswith("fail"):
        assert port.pause_extra is not None
        assert port.pausable_extra is not None


# --------------------------------------------------------------------------- #
# The sparse engine against the reference
# --------------------------------------------------------------------------- #
FLOAT64_CASES = {
    "pod_incast_grid": (SCENARIOS["pod_incast_grid"], {}),
    "fail_tc": (SCENARIOS["fail_tc"], {}),
    "fail_tc_flap": (SCENARIOS["fail_tc_flap"], {}),
    "pod_shuffle": (SCENARIOS["pod_shuffle"], {}),
    "pod_storm_grid": (lambda M: M["SC"].pod_storm_grid(
        sim_time_s=0.0005)[0], {}),
    "cc_zoo_sparse": (_cc_grid, {"incidence": "sparse"}),
}


@pytest.mark.parametrize("name", FLOAT64_CASES)
def test_float64_equals_reference_numpy(name):
    make, kw = FLOAT64_CASES[name]
    want = ref_sweep(make(REF), backend="numpy", **kw)
    got = run_fabric_sweep(make(PORT), device="cpu", dtype=torch.float64,
                           **kw)
    _held(got, want, 1e-9)
    if name == "pod_shuffle":
        # traffic transits the super-spine tier
        assert float(got["uplink_util_max"][0]) > 0.0
    if name == "pod_storm_grid":
        assert (got["pause_storm"] > 0.0).all()


def test_float32_within_tier_of_reference_jax():
    make = lambda M: M["SC"].pod_incast_grid(  # noqa: E731
        pods=2, leaves_per_pod=2, hosts_per_leaf=2, burst_mb=0.2,
        sim_time_s=0.0005)[0]
    want = ref_sweep(make(REF), backend="jax")
    got = run_fabric_sweep(make(PORT), device="cpu")
    for k in ("flow_goodput_gbps", "flow_completion_us",
              "incast_completion_us", "victim_goodput_gbps",
              "pause_fanout", "ecn_marked_bytes", "switch_dropped_bytes",
              "uplink_util_max"):
        assert rel(got[k], want[k]) <= 5e-4, k


@pytest.mark.parametrize("grid", ["incast", "cc_zoo"])
def test_two_tier_sparse_equals_dense(grid):
    """On a 2-tier grid the slot layout runs the dense tick's arithmetic
    in the same order: every output equal in float64 (the sparse run
    adds the uplinks' utilization)."""
    scens = _cc_grid(PORT) if grid == "cc_zoo" else [
        TSC.incast(n_senders=4, mode=m, burst_mb=0.2, pfc=p,
                   sim_time_s=0.0005)
        for m in ("ddio", "jet") for p in (False, True)]
    dense = run_fabric_sweep(scens, device="cpu", dtype=torch.float64,
                             incidence="dense")
    sparse = run_fabric_sweep(scens, device="cpu", dtype=torch.float64,
                              incidence="sparse")
    assert set(sparse) - set(dense) == {"uplink_util", "uplink_util_max",
                                        "uplink_util_mean"}
    for k in dense:
        a, b = np.asarray(dense[k]), np.asarray(sparse[k])
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), k


def test_auto_incidence_picks_the_sparse_engine_for_super_spines():
    pod = TSC.pod_incast_grid(pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                              burst_mb=0.2, sim_time_s=0.0003)[0]
    got = run_fabric_sweep(pod, device="cpu", dtype=torch.float64)
    want = run_fabric_sweep(pod, device="cpu", dtype=torch.float64,
                            incidence="sparse")
    assert "uplink_util_max" in got
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k
    # a 2-tier grid stays dense: no uplink utilization without routing
    two = run_fabric_sweep([TSC.incast(2, sim_time_s=0.00005)],
                           device="cpu")
    assert "uplink_util_max" not in two


def test_refusals_match_the_reference():
    pod = TSC.pod_incast(pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                         sim_time_s=0.0001)
    with pytest.raises(ValueError, match="sparse"):
        run_fabric_sweep([pod], device="cpu", incidence="dense")
    with pytest.raises(ValueError, match="dense-engine only"):
        run_fabric_sweep([pod], device="cpu", adaptive_dt=True)
    fsp = FabricSweepParams.from_scenarios([pod], sparse=True)
    with pytest.raises(ValueError, match="dense-engine only"):
        FabricRun(fsp, device="cpu", adaptive=fused.AdaptiveConfig())
    dyn = TSC.incast(n_senders=2, sim_time_s=0.0001)
    dyn.fabric.routing = RoutingConfig(mode="adaptive")
    with pytest.raises(ValueError, match="static_ecmp"):
        run_fabric_sweep([dyn], device="cpu", incidence="sparse")
    msg = TSC.incast(n_senders=2, sim_time_s=0.0001)
    msg.fabric.msg = MessageConfig()
    with pytest.raises(ValueError, match="message layer"):
        run_fabric_sweep([msg], device="cpu", incidence="sparse")
    flt = TSC.incast(n_senders=2, sim_time_s=0.0001)
    flt.fabric.faults = FaultConfig(0.01)
    with pytest.raises(ValueError, match="FaultConfig"):
        run_fabric_sweep([flt], device="cpu", incidence="sparse")
    with pytest.raises(ValueError, match="incidence"):
        run_fabric_sweep([dyn], device="cpu", incidence="csr")


# --------------------------------------------------------------------------- #
# The static-buffer chain, the tensor tick, the footprint
# --------------------------------------------------------------------------- #
def test_chain_equals_eager_loop_on_a_pod_grid():
    fsp = FabricSweepParams.from_scenarios([_fail_tc(PORT, True, 0.0004)],
                                           sparse=True)
    assert fsp.ticks % 3 != 0
    want = FabricRun(fsp, device="cpu", graph=False).run()
    run = FabricRun(fsp, device="cpu", chain=3)
    got = run.run()
    assert run.iterations == fsp.ticks and int(run.t) == fsp.ticks
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def test_tensor_tick_equals_int_tick_on_a_pod_grid():
    fsp = FabricSweepParams.from_scenarios(
        SCENARIOS["pod_storm_grid"](PORT)[:2], sparse=True)
    runs = [FabricRun(fsp, device="cpu", graph=False) for _ in range(2)]
    a, b = runs[0].state, runs[1].state
    for t in range(60):
        a = runs[0].step(a, t)
        tt = torch.tensor(t)
        b = runs[1].step(b, tt, tt)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _footprint(hosts_per_leaf, pods, leaves):
    """Elements the sparse engine keeps: state, per-point parameters,
    statics and segment-sum plans."""
    scens = TSC.pod_incast_grid(pods=pods, leaves_per_pod=leaves,
                                hosts_per_leaf=hosts_per_leaf,
                                burst_mb=0.2, sim_time_s=0.00001)[0]
    fsp = FabricSweepParams.from_scenarios(scens, sparse=True)
    run = FabricRun(fsp, device="cpu", graph=False)

    def items(v):
        return v if isinstance(v, list) else [v]
    n = sum(v.numel() for v in run.state.values())
    n += sum(v.size for v in TV._np_params(fsp, np.float32).values())
    n += sum(np.asarray(a).size for v in TV._static(fsp).values()
             for a in items(v))
    n += sum(t.numel() for v in TV._seg_plans(fsp, "cpu").values()
             for pl in items(v) for t in (pl.idx, pl.perm, pl.offsets))
    return n


def test_footprint_grows_with_flows_not_ports():
    """64 -> 256 hosts (the ``scale`` bench's points): the sparse
    engine's elements grow with flows x hops while the per-receiver
    state stays, exponent ~0.8 against the reference's ceiling of
    1.6."""
    small, large = _footprint(16, 2, 2), _footprint(16, 4, 4)
    exponent = math.log(large / small) / math.log(4.0)
    assert large > small and exponent <= 1.6, (small, large, exponent)
