"""The dense fabric tick with the tick as a device tensor, run over static
buffers in chains (the body a CUDA graph captures), on the CPU.

* the step with a 0-d tensor tick equals the step with a Python tick,
  element for element, on a grid of each dense branch (static, dynamic
  routing with a failure and a flap, WRR, per-TC host PFC, the CC zoo,
  messages, faults with a crash), in float64 and float32;
* the static-buffer chained body (``graph="auto"`` on the CPU) equals the
  eager loop (``graph=False``) at chain lengths 1, 3 and one that does
  not divide the tick count;
* the adaptive replay plan ends exactly at the last tick and starts no
  iteration past it, for any stride sequence;
* one iteration, fixed or adaptive, creates no tensor from host data
  and reads nothing back to the host (either would break the capture);
* the chain refuses a body that changes a state's keys or dtype, and the
  entry point refuses an unknown graph mode;
* launch counts outside a capture are the host's own.

The capture itself needs the card (``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _hypothesis_compat import given, settings, st
from repro_torch.fabric import FaultConfig, fused
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric.tickgraph import TickChain, adaptive_batches
from repro_torch.fabric.vector import (FabricRun, FabricSweepParams,
                                       run_fabric_sweep)

torch.set_num_threads(1)

SIM_S = 0.0003          # 300 ticks: every failure, flap and crash fires


def _static():
    return [TSC.incast(4, mode=m, burst_mb=0.5, pfc=p, sim_time_s=SIM_S)
            for m in ("jet", "ddio") for p in (False, True)]


def _dynamic():
    """Adaptive and weighted ECMP under an uplink failure at 50 us, and a
    periodic flap under adaptive routing."""
    out = TSC.routing_grid(modes=("weighted_ecmp", "adaptive", "spray"),
                           fail_at_us=(50.0,), burst_mb=0.5, n_senders=4,
                           sim_time_s=SIM_S)[0]
    s = TSC.link_failure_incast(n_senders=4, routing="adaptive",
                                burst_mb=0.5, fail_at_us=math.inf,
                                sim_time_s=SIM_S)
    s.topology.flap_link("leaf0", "spine1", start_us=40.0, period_us=100.0,
                         down_us=30.0)
    return out + [s]


def _cc():
    return [TSC.message_incast(4, algo=a, sim_time_s=SIM_S)
            for a in ("dcqcn", "timely", "hpcc")]


def _messages():
    return TSC.message_sweep_grid(msg_kb=(16.0,), window=(1, 16),
                                  verb=("write",), algo=("dcqcn",),
                                  n_senders=4, sim_time_s=SIM_S)[0]


def _faults():
    """go-back-N and selective at 2 % loss, and a receiver crash at
    100-200 us under selective recovery."""
    out = TSC.lossy_incast_grid(loss_rate=(0.02,),
                                recovery=("go_back_n", "selective"),
                                n_senders=4, sim_time_s=SIM_S)[0]
    crash = TSC.lossy_incast(n_senders=4, loss_rate=0.005,
                             recovery="selective", sim_time_s=SIM_S)
    crash.fabric.faults = FaultConfig(0.005, seed=7).crash("h1_0", 100.0,
                                                          200.0)
    return out + [crash]


GRIDS = {"static": _static, "dynamic": _dynamic,
         "wrr": lambda: TSC.wrr_pair(SIM_S),
         "host_tc": lambda: TSC.host_gate_pair(SIM_S),
         "cc": _cc, "messages": _messages, "faults": _faults}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _same(a, b) -> bool:
    """Element for element, NaNs in the same places."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def _states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert _same(a[k].numpy(), b[k].numpy()), k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_tensor_tick_equals_int_tick(grid, dtype):
    fsp = FabricSweepParams.from_scenarios(GRIDS[grid]())
    runs = [FabricRun(fsp, device="cpu", dtype=DTYPES[dtype], graph=False)
            for _ in range(2)]
    a, b = runs[0].state, runs[1].state
    for t in range(fsp.ticks):
        a = runs[0].step(a, t)
        tt = torch.tensor(t)
        b = runs[1].step(b, tt, tt)
    _states_equal(a, b)


def test_tick_helpers_take_a_tensor_tick_past_65536():
    """``fault_drops`` (the split modmul of the counter hash) and
    ``link_state`` give the same masks, in the same dtypes, for a 0-d
    tensor tick as for a Python tick, past the hash's 65,536-tick
    period."""
    from repro_torch.fabric import vector as TV
    rng = np.random.default_rng(3)
    saltp = TV.fault_saltp(torch.as_tensor(rng.integers(0, 1 << 20, (3, 7))))
    thr = torch.as_tensor(rng.integers(0, 65536, (3, 7)))
    cthr = torch.as_tensor(rng.integers(0, 4000, (3, 7)))
    p = {k: torch.as_tensor(rng.integers(0, 200, (3, 7)))
         for k in ("fail_at", "fail_until", "flap_start", "flap_down")}
    p["flap_period"] = p["flap_down"] + 5
    for t in (0, 1, 255, 256, 65535, 65536, 70001, 131072, 1 << 20):
        tt = torch.tensor(t)
        a, b = TV.fault_drops(t, saltp, thr, cthr), \
            TV.fault_drops(tt, saltp, thr, cthr)
        assert a.dtype == b.dtype and torch.equal(a, b), t
        for x, y in zip(TV.link_state(t % 300, p, True),
                        TV.link_state(tt % 300, p, True)):
            assert x.dtype == y.dtype and torch.equal(x, y), t


@pytest.mark.parametrize("chain", [1, 3, 7])
@pytest.mark.parametrize("grid", ["static", "dynamic", "messages",
                                  "faults"])
def test_chained_body_equals_eager_loop(grid, chain):
    """300 ticks: chains of 1, of 3 (100 chains) and of 7 (42 chains and
    6 single ticks) against the eager loop, every output."""
    fsp = FabricSweepParams.from_scenarios(GRIDS[grid]())
    assert fsp.ticks % 7 != 0
    want = FabricRun(fsp, device="cpu", dtype=torch.float32,
                     graph=False).run()
    run = FabricRun(fsp, device="cpu", dtype=torch.float32, chain=chain)
    got = run.run()
    assert run.iterations == fsp.ticks and int(run.t) == fsp.ticks
    assert got.keys() == want.keys()
    for k in want:
        assert _same(got[k], want[k]), k


def test_run_fabric_sweep_defaults_to_the_chained_body():
    scens = _static()
    a = run_fabric_sweep(scens, device="cpu")
    b = run_fabric_sweep(scens, device="cpu", graph=False)
    for k in a:
        assert _same(a[k], b[k]), k


class _HostOps(TorchDispatchMode):
    """Records the ops that a CUDA graph capture refuses: a tensor made
    from host data (``torch.tensor``: ``lift_fresh``) and a read of a
    device value (``.item()``, ``int()``: ``_local_scalar_dense``)."""

    REFUSED = ("aten.lift_fresh", "aten._local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.REFUSED):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed", "adaptive"])
@pytest.mark.parametrize("grid", GRIDS)
def test_iteration_is_capturable(grid, adaptive):
    """What the card captures (the fixed tick, or the adaptive
    iteration), run on the CPU under a recorder."""
    fsp = FabricSweepParams.from_scenarios(GRIDS[grid]())
    run = FabricRun(fsp, device="cpu",
                    adaptive=fused.AdaptiveConfig() if adaptive else None)
    with _HostOps() as rec:
        run.chain.enqueue(2)
    assert rec.seen == []


def _simulate_plan(ticks, max_stride, strides):
    """The plan over a fake engine whose iteration ``j`` takes
    ``strides[j % len]`` ticks, capped as ``make_stride_fn`` caps it."""
    t, j, starts = 0, 0, []

    def run(n):
        nonlocal t, j
        for _ in range(n):
            starts.append(t)
            t += min(strides[j % len(strides)], max_stride, ticks - t)
            j += 1
        return t
    iterations, batches = adaptive_batches(ticks, max_stride, run)
    return t, iterations, batches, starts


@settings(max_examples=200, deadline=None)
@given(ticks=st.integers(1, 3000), max_stride=st.integers(1, 32),
       strides=st.lists(st.integers(1, 32), min_size=1, max_size=50))
def test_adaptive_plan_ends_exactly_at_ticks(ticks, max_stride, strides):
    t, iterations, batches, starts = _simulate_plan(ticks, max_stride,
                                                    strides)
    assert t == ticks
    assert iterations == len(starts)
    assert all(s < ticks for s in starts)        # no iteration past the end
    assert 1 <= batches <= iterations


def test_adaptive_plan_host_reads():
    """All strides 1 at max_stride 16 is the plan's worst case: each batch
    runs 1/16 of what is left; 20,000 ticks take under 150 reads."""
    t, iterations, batches, _ = _simulate_plan(20000, 16, [1])
    assert (t, iterations) == (20000, 20000)
    assert batches < 150
    assert _simulate_plan(20000, 1, [1])[2] == 1
    assert _simulate_plan(20000, 16, [16])[2] == 1


def _counter_body(t):
    def body(s):
        t.add_(1)
        return {"x": s["x"] + 1.0, "ring": s["ring"]}
    return body


def test_chain_copies_back_and_keeps_in_place_buffers():
    t = torch.zeros((), dtype=torch.int64)
    state = {"x": torch.zeros(3), "ring": torch.zeros(2)}
    ring = state["ring"]
    chain = TickChain(_counter_body(t), state, (t,), 4, capture=False)
    chain.run(10)
    assert int(t) == 10 and chain.state["ring"] is ring
    assert torch.equal(chain.state["x"], torch.full((3,), 10.0))


def test_chain_refuses_a_body_that_changes_the_state():
    t = torch.zeros((), dtype=torch.int64)
    state = {"x": torch.zeros(3, dtype=torch.int32)}
    chain = TickChain(lambda s: {"x": s["x"].to(torch.int64)}, state, (t,),
                      2, capture=False)
    with pytest.raises(RuntimeError, match="int64"):
        chain.run(2)
    chain = TickChain(lambda s: {"y": s["x"]}, state, (t,), 2,
                      capture=False)
    with pytest.raises(RuntimeError, match="keys"):
        chain.run(1)
    with pytest.raises(ValueError):
        TickChain(lambda s: s, state, (t,), 0, capture=False)


def test_entry_point_refuses_unknown_graph_modes():
    scens = _static()[:1]
    with pytest.raises(ValueError, match="graph"):
        run_fabric_sweep(scens, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph"):
        run_fabric_sweep(scens, device="cpu", graph="cuda")


def test_launch_counts_outside_a_capture():
    """A launch outside a capture adds one on the host, ``read`` returns
    the host counts when nothing was captured, and ``reset`` zeroes every
    count; an uncaptured run (the CPU's) has no captured launches."""
    from repro_torch._device import LaunchCounts
    counts = LaunchCounts(a=0, b=0)
    for _ in range(3):
        counts.add("a", torch.device("cpu"))
    assert counts.read() == {"a": 3, "b": 0}
    assert counts.captured == {"a": 0, "b": 0}
    counts.reset()
    assert counts.read() == {"a": 0, "b": 0}
    run = FabricRun(FabricSweepParams.from_scenarios(_static()),
                    device="cpu")
    run.run()
    assert run.chain.per_iteration == {} and run.launches_captured() == {}
