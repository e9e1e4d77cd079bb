"""The port's single-host scalar engines against the reference, bit for
bit, on the CPU: the recycle and pool-sizing arithmetic, ``HostDatapath``
step for step, ``ReceiverHost``, ``run_sim`` with every ``SimResult``
field equal with ``==`` (NaN where the reference has NaN), the
reference's golden rows, and the Jet testbed configuration.

These engines are host code in both packages (Python floats, numpy
float64 release rings), so the same operations in the same order give
the same bits; there is no tolerance.  The paper's C1-C7 grid runs here
at 5 ms instead of the reference tests' 20 ms (a depth cut for time);
the golden rows keep their own depths.
"""
import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from _scalar_same import mismatches
from repro.configs import jet_testbed as RJT
from repro.core import datapath as RD
from repro.core import recycle as RR
from repro.core import simulator as RS
from repro_torch.configs import jet_testbed as TJT
from repro_torch.core import datapath as TD
from repro_torch.core import recycle as TR
from repro_torch.core import simulator as TS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MSG_SIZES = [4 << 10, 16 << 10, 64 << 10, 100_000, 256 << 10, 1 << 20,
             3 << 20, 4 << 20]
GRID_S = 0.005          # C1-C7 grid depth: 20 ms cut to 5 ms


def assert_same(got, want):
    bad = mismatches(got, want)
    assert not bad, bad[:5]


# --------------------------------------------------------------------------- #
# recycle / pool sizing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["paper_default", "paper_unoptimized"])
def test_recycle_arithmetic_equals_reference(model):
    t, r = getattr(TR, model)(), getattr(RR, model)()
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert t.process_ns_per_byte() == r.process_ns_per_byte()
    for n in MSG_SIZES:
        assert TR.slice_message(n) == RR.slice_message(n)
        assert t.slot_holding_time_us(n) == r.slot_holding_time_us(n)
        assert t.message_latency_us(n) == r.message_latency_us(n)
        for gbps in (25.0, 100.0, 200.0):
            assert t.resident_bytes(gbps, n) == r.resident_bytes(gbps, n)
            assert t.required_pool_bytes(gbps, n) \
                == r.required_pool_bytes(gbps, n)
            assert t.required_pool_bytes(gbps, n, headroom=1.0) \
                == r.required_pool_bytes(gbps, n, headroom=1.0)


def test_slice_and_little_law():
    assert TR.slice_message(10_000, 4096) == [4096, 4096, 1808]
    assert TR.slice_message(8192, 4096) == [4096, 4096]
    for n in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            TR.slice_message(n)
    # the paper's feasibility line: 200 Gbps x 200 us = 5 MB
    assert TR.little_law_bytes(200.0, 200.0) == 5e6
    for gbps, us in ((25.0, 3.0), (200.0, 61.3), (100.0, 0.0)):
        assert TR.little_law_bytes(gbps, us) == RR.little_law_bytes(gbps, us)


# --------------------------------------------------------------------------- #
# HostDatapath step for step
# --------------------------------------------------------------------------- #
def _pressure(M, mode="jet"):
    """The reference's escape-pressure corner (tests/test_datapath.py:53):
    a 2 MB pool, 30 % stragglers held 100x longer."""
    return M.testbed_100g(mode, msg_bytes=256 << 10, jet_pool_bytes=2 << 20,
                          straggler_frac=0.3, straggler_mult=100.0)


DP_CASES = {
    "ddio": lambda M: M.testbed_100g("ddio", msg_bytes=1 << 20),
    "jet": lambda M: M.testbed_100g("jet"),
    "jet_pressure": _pressure,
    "jet_25g_unpipelined": lambda M: M.testbed_25g(
        "jet", recycle=M.RecycleModel(threads=2)),
}

DP_STATE = ("qos_q", "resident", "strag_resident", "escape_debt",
            "replace_debt", "pool_cap", "replace_mem", "ecn_escape_accum_us",
            "nic_dram_bytes", "escape_dram_bytes", "mem_fallback_bytes",
            "miss_sum", "miss_n", "pool_peak", "pool_sum", "replaces",
            "copies", "ecns", "hold_us", "d_base", "d_strag", "horizon",
            "dt", "rnic_q")


def _arrivals(seed, ticks, per_class):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        if per_class:
            x = rng.exponential(4e4, 3) * (rng.random(3) < 0.7)
            out.append([float(v) for v in x] if t % 2 else tuple(x))
        else:
            out.append(float(rng.exponential(3e4)) if t % 5 else 0.0)
    return out


def _dp_state(dp):
    s = {k: getattr(dp, k) for k in DP_STATE}
    s["rel_base"] = dp.rel_base.copy()
    s["rel_strag"] = dp.rel_strag.copy()
    return s


@pytest.mark.parametrize("per_class", [False, True],
                         ids=["float", "per_class"])
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_host_datapath_step_for_step(case, per_class):
    ticks = 1500
    tc, rc = DP_CASES[case](TS), DP_CASES[case](RS)
    t_dp = TD.HostDatapath(tc, ticks)
    r_dp = RD.HostDatapath(rc, ticks, dt_us=rc.dt_us)
    assert_same(_dp_state(t_dp), _dp_state(r_dp))
    arr = _arrivals(sorted(DP_CASES).index(case), ticks, per_class)
    crash = 700
    for t, a in enumerate(arr):
        if t == crash:
            t_dp.crash_reset()
            r_dp.crash_reset()
        assert_same(t_dp.admit_link(a), r_dp.admit_link(a))
        cpu = 1200.0 + 500.0 * ((t // 100) % 2)
        assert_same(t_dp.step(t, cpu), r_dp.step(t, cpu))
        if t % 50 == 0 or t == crash:
            assert_same(_dp_state(t_dp), _dp_state(r_dp))
    assert_same(_dp_state(t_dp), _dp_state(r_dp))
    if case == "jet_pressure":
        # the ladder's rungs fired: REPLACE and ECN (and the LOW spill
        # when arrivals are classed)
        assert t_dp.replaces > 0 and t_dp.ecns > 0
        if per_class:
            assert t_dp.mem_fallback_bytes > 0.0


def test_host_datapath_horizon_guard():
    c = TS.testbed_100g("jet", dt_us=2.0)
    dp = TD.HostDatapath(c, 10)
    assert dp.horizon == 10 + 500_000 == RD.HostDatapath(c, 10).horizon
    dp.step(dp.horizon - 1, c.cpu_membw_gbps)
    with pytest.raises(RuntimeError, match="past its horizon"):
        dp.step(dp.horizon, c.cpu_membw_gbps)
    host = TS.ReceiverHost(c, sim_ticks=10)
    host.t = host.dp.horizon
    with pytest.raises(RuntimeError, match="ReceiverHost stepped past"):
        host.step(0.0)


# --------------------------------------------------------------------------- #
# ReceiverHost
# --------------------------------------------------------------------------- #
RH_CASES = {
    "25g_ddio_pfc": lambda M: M.testbed_25g("ddio"),
    "25g_ddio_pfc_per_tc": lambda M: M.testbed_25g("ddio",
                                                   host_pfc_per_tc=True),
    "100g_jet_pressure": _pressure,
}


@pytest.mark.parametrize("case", sorted(RH_CASES))
def test_receiver_host_step_for_step(case):
    ticks = 2000
    th = TS.ReceiverHost(RH_CASES[case](TS), sim_ticks=ticks)
    rh = RS.ReceiverHost(RH_CASES[case](RS), sim_ticks=ticks)
    arr = _arrivals(7, ticks, per_class=True)
    paused = set()
    for t, a in enumerate(arr):
        if t == 1200:
            th.crash_reset()
            rh.crash_reset()
        a = [0.0 if q in th.paused_classes else v for q, v in enumerate(a)]
        assert th.paused_classes == rh.paused_classes
        assert_same(th.step(a), rh.step(a))
        assert (th.rnic_q, th.resident, th.pfc_paused, th.pfc_paused_cls,
                th.cnp_count, th.pfc_pause_us) == (
            rh.rnic_q, rh.resident, rh.pfc_paused, rh.pfc_paused_cls,
            rh.cnp_count, rh.pfc_pause_us)
        paused |= th.paused_classes
    assert_same(th.finalize(), rh.finalize())
    assert (th.starts, th.dones) == (rh.starts, rh.dones)
    if case.startswith("25g"):
        assert paused, "the 25G testbed's PFC gate never fired"


# --------------------------------------------------------------------------- #
# run_sim over the paper's C1-C7 grid and the extra knobs
# --------------------------------------------------------------------------- #
GRID = [(bed, kb, mode) for bed in ("100g", "25g") for kb in (64, 256, 1024)
        for mode in ("ddio", "jet")]


def _sim(M, bed, **kw):
    mk = M.testbed_100g if bed == "100g" else M.testbed_25g
    return mk(**kw)


@pytest.mark.parametrize("bed,kb,mode", GRID,
                         ids=[f"{b}-{k}k-{m}" for b, k, m in GRID])
def test_run_sim_equals_reference(bed, kb, mode):
    kw = dict(mode=mode, msg_bytes=kb << 10, sim_time_s=GRID_S)
    got = TS.run_sim(_sim(TS, bed, **kw))
    want = RS.run_sim(_sim(RS, bed, **kw))
    assert_same(got, want)
    assert list(got.as_row()) == list(want.as_row())
    assert_same(got.as_row(), want.as_row())
    assert got.goodput_gbps > 0.0


def _membw(t_s):
    """CPU-side DRAM contention that steps every millisecond."""
    return (1100.0, 1500.0, 1900.0)[int(t_s * 1e3) % 3]


EXTRA = {
    "cpu_membw_schedule": ("100g", dict(mode="ddio", msg_bytes=512 << 10,
                                        cpu_membw_schedule=_membw)),
    "host_pfc_per_tc_25g": ("25g", dict(mode="ddio", host_pfc_per_tc=True)),
    "offered_incast_dt2": ("100g", dict(mode="jet", incast_senders=4,
                                        offered_gbps=150.0, dt_us=2.0)),
    "jet_pressure": ("100g", dict(mode="jet", jet_pool_bytes=2 << 20,
                                  straggler_frac=0.3,
                                  straggler_mult=100.0)),
}


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_run_sim_knobs_equal_reference(case):
    bed, kw = EXTRA[case]
    kw = dict(kw, sim_time_s=GRID_S)
    got = TS.run_sim(_sim(TS, bed, **kw))
    assert_same(got, RS.run_sim(_sim(RS, bed, **kw)))
    assert_same(TS.ReceiverSim(_sim(TS, bed, **kw)).run(), got)
    if case == "host_pfc_per_tc_25g":
        assert got.pfc_pause_us > 0.0


def test_cpu_membw_schedule_moves_goodput():
    base = dict(mode="ddio", msg_bytes=512 << 10, sim_time_s=0.003)
    flat = TS.run_sim(TS.testbed_100g(**base))
    sched = TS.run_sim(TS.testbed_100g(**base, cpu_membw_schedule=_membw))
    assert sched.goodput_gbps != flat.goodput_gbps


def test_sweep_refuses_a_schedule_and_names_run_sim():
    """The receiver sweep packs one CPU-contention value a point, so it
    refuses a schedule and points to the scalar engine that takes one."""
    from repro_torch.fabric import SweepParams
    cfg = TS.testbed_100g("ddio", cpu_membw_schedule=_membw)
    with pytest.raises(ValueError, match="repro_torch.core.run_sim"):
        SweepParams.from_configs([cfg])


def test_no_sample_gives_nan_latency():
    """Too short a run completes no message: the latency fields are NaN in
    both packages, in the same places."""
    kw = dict(mode="ddio", msg_bytes=4 << 20, sim_time_s=0.0002)
    got = TS.run_sim(TS.testbed_25g(**kw))
    assert math.isnan(got.avg_latency_us) and math.isnan(got.p99_latency_us)
    assert_same(got, RS.run_sim(RS.testbed_25g(**kw)))


# the reference's golden rows (tests/test_datapath.py:32-43), each at its
# own depth of 20 ms
_GOLD = {
    ("100g", "ddio"): dict(goodput_gbps=116.68822835927475,
                           avg_latency_us=635.5263277419357,
                           cnp_count=15.0,
                           ddio_miss_rate=0.9444188874605015,
                           nic_dram_gbps=221.05323616147538,
                           pfc_pause_us=0.0, completed_messages=1088),
    ("100g", "jet"): dict(goodput_gbps=200.0,
                          avg_latency_us=396.0716515555555,
                          cnp_count=0.0, ddio_miss_rate=0.0,
                          nic_dram_gbps=0.0, pfc_pause_us=0.0,
                          completed_messages=1888),
    ("25g", "ddio"): dict(goodput_gbps=28.0,
                          avg_latency_us=2787.78036,
                          cnp_count=0.0, ddio_miss_rate=1.0,
                          nic_dram_gbps=56.0, pfc_pause_us=8598.0,
                          completed_messages=256),
    ("25g", "jet"): dict(goodput_gbps=50.0,
                         avg_latency_us=1402.669942153846,
                         cnp_count=0.0, ddio_miss_rate=0.0,
                         nic_dram_gbps=0.0, pfc_pause_us=0.0,
                         completed_messages=448),
}


@pytest.mark.parametrize("bed,mode", sorted(_GOLD))
def test_golden_rows_reproduced(bed, mode):
    r = TS.run_sim(_sim(TS, bed, mode=mode, msg_bytes=256 << 10,
                        sim_time_s=0.02))
    for key, want in _GOLD[(bed, mode)].items():
        assert getattr(r, key) == want, (bed, mode, key)


# --------------------------------------------------------------------------- #
# configuration, exports and the host-code rule
# --------------------------------------------------------------------------- #
def test_jet_testbed_equals_reference():
    assert dataclasses.asdict(TJT.JET_CONFIG) \
        == dataclasses.asdict(RJT.JET_CONFIG)
    assert list(TJT.TESTBEDS) == list(RJT.TESTBEDS)
    for name in TJT.TESTBEDS:
        for mode in ("ddio", "jet"):
            assert dataclasses.asdict(TJT.TESTBEDS[name](mode)) \
                == dataclasses.asdict(RJT.TESTBEDS[name](mode)), name
    from repro_torch.configs import ARCHS
    assert "jet_testbed" not in ARCHS and "jet" not in ARCHS


def test_core_exports_cover_the_reference():
    import repro.core as R
    import repro_torch.core as T
    missing = [n for n in R.__all__ if not hasattr(T, n)]
    assert not missing
    assert set(R.__all__) <= set(T.__all__)


SCALAR_FILES = ["core/recycle.py", "core/datapath.py", "core/simulator.py",
                "fabric/switch.py", "fabric/hosts.py", "fabric/fabric.py",
                "configs/jet_testbed.py"]


@pytest.mark.parametrize("name", SCALAR_FILES)
def test_scalar_engines_are_host_code(name):
    """The scalar engines import no torch and take no device: they are
    the port's CPU oracle, not a fallback of a device path."""
    tree = ast.parse((ROOT / "src" / "repro_torch" / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in mods if m.split(".")[0] == "torch"]
    args = [a.arg for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            for a in n.args.args + n.args.kwonlyargs]
    assert "device" not in args
