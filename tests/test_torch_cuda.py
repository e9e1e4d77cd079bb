"""The port's CUDA kernels on the card (``cuda`` marker): the water-fills
and the segment sum bit for bit (the segment sum against its plain
version run on the CPU, launch after launch), and the fabric engines
that run them (the sparse pod tick through its captured graph equal to
its eager loop, its launches counted on the card; the dense tick under
dynamic routing and a link failure, under the CC zoo with verbs messages,
and under loss, recovery and a receiver crash, each against CPU float64;
its captured CUDA graphs equal to the eager loop and within 5e-4 of the
scalar driver ``run_fabric``, and adaptive dt within its bound of the
CPU run; the sweep farm's chunks equal to the
monolithic run, a captured run re-armed by ``FabricRun.load`` equal to a
fresh capture; the receiver sweep bit for bit against the CPU); flash
attention, the SSD scan, the paged decode attention and the staged
matmul within the tolerances of ``tests/test_kernels.py``, each
flash case on the kernel variant its type and head dim select (two at
llama-3.2-vision's cross-attention over 1,600 patches), tiny vision and
musicgen prefills through the kernels against the plain versions, each
SSD case on the variant its widths select, and the staged matmul's
wgmma kernel bit for bit on small-integer operands; each against its
plain version, each staged matmul shape on the kernel variant its type
and shape select.  Training: the flash attention backward against its
plain version (autograd's gradient of the plain forward) at the train
path's shapes on the variant its type picks (the first design forced
too), deterministic, zero for rows that see no key, its tile plan the C
launcher's; the serve
path's flash launches unchanged without grad; the kernels with no
backward raising under grad (an SSD family cannot train on the card);
tiny models' gradients through the kernels against the plain versions
under each remat policy.

Needs an NVIDIA card and ``nvcc``; every test skips without one.  The
file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import gc
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, tiny_config
from repro_torch.fabric import CcConfig, fused
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric.tickgraph import TickChain
from repro_torch.fabric.vector import (FabricRun, FabricSweepParams,
                                       run_fabric_sweep)
from repro_torch._device import full_fp32_matmul
from repro_torch.kernels import jet_decode_attention as jda
from repro_torch.kernels import jet_flash_attention as jfa
from repro_torch.kernels import jet_staged_matmul as jsm
from repro_torch.kernels import mamba2_ssd as mssd
from repro_torch.kernels import ops
from repro_torch.models import api

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SHAPES = [(48, 3, 14), (48, 3, 2), (5, 3, 130), (1, 3, 1),
          (4096, 3, 4096)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _inputs(seed, shape, dev):
    rng = np.random.default_rng(seed)
    g, q, n = shape
    demand = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    demand[rng.random(shape) < 0.2] = 0.0
    can = rng.random(shape) < 0.7
    can[0] = False
    budget = rng.uniform(0.0, 6.0, (g, n)).astype(np.float32)
    crumb = np.full((g, n), 1e-3, np.float32)
    return [torch.from_numpy(a).to(dev) for a in (demand, can, budget,
                                                  crumb)]


def _counted(scens, **kw):
    """A run on the card with the water-fill launch counts zeroed after
    its set-up (the capture and its warm-up) and read after it: the
    results, the counts (a replay's launches added on the card) and the
    launches captured for one iteration times the iterations run."""
    run = FabricRun(FabricSweepParams.from_scenarios(scens), **kw)
    fused.reset_launches()
    res = run.run()
    return res, fused.LAUNCHES.read(), run.launches_captured()


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_bitwise(card, shape):
    demand, can, budget, crumb = _inputs(6, shape, card)
    fused.reset_launches()
    got = fused.priority_grants(demand, can, budget, crumb)
    acc = fused.priority_admit(demand, budget)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"priority_grants": 1, "priority_admit": 1,
                              "seg_sum": 0}
    assert _same_bits(got, fused.priority_grants_ref(demand, can, budget,
                                                     crumb))
    assert _same_bits(acc, fused.priority_admit_ref(demand, budget))


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    demand, can, budget, crumb = _inputs(7, (4, 3, 8), card)
    with pytest.raises(TypeError):
        fused.priority_grants(demand, can.float(), budget, crumb)
    with pytest.raises(TypeError):
        fused.priority_admit(demand.double(), budget.double())
    with pytest.raises(ValueError):
        fused.priority_admit(demand[:, :, :4], budget)
    with pytest.raises(ValueError):
        fused.priority_grants(demand, can, budget.cpu(), crumb)


def test_engine_runs_through_the_kernels(card):
    scens = [TSC.incast(4, mode=m, burst_mb=1.0, pfc=p, sim_time_s=0.0002)
             for m in ("jet", "ddio") for p in (False, True)]
    got, launches, captured = _counted(scens)
    assert launches == captured == {"priority_grants": 800,
                                    "priority_admit": 200, "seg_sum": 0}
    want = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    for k in ("flow_goodput_gbps", "flow_completion_us"):
        a, b = got[k], want[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=5e-4, atol=0.0), k


def test_graph_matches_the_scalar_driver(card):
    """A 4-point incast grid (DDIO / Jet x PFC off / on) at 2 ms through
    the captured graph, against the port's scalar ``run_fabric`` (host
    code, Python floats): goodput and incast completion within 5e-4
    (``bench_floors.json``'s ``fabric_sweep`` ceilings), identical finite
    masks, pause fan-out equal point for point."""
    scens = [TSC.incast(8, mode=m, pfc=p, burst_mb=1.0, sim_time_s=0.002)
             for m in ("ddio", "jet") for p in (False, True)]
    got, launches, captured = _counted(scens)
    assert launches == captured == {"priority_grants": 8000,
                                    "priority_admit": 2000, "seg_sum": 0}
    res = [s.run() for s in scens]
    F = len(scens[0].flows)
    want = {"flow_goodput_gbps": np.array(
                [[r.flow_goodput_gbps[f] for f in range(F)] for r in res]),
            "incast_completion_us": np.array(
                [r.incast_completion_us for r in res])}
    _held_to_cpu(got, want, sorted(want))
    assert got["pause_fanout"].tolist() == [r.pause_fanout for r in res]
    assert max(r.pause_fanout for r in res) >= 2


def test_receiver_sweep_on_the_card_equals_the_cpu_run(card):
    """Float32 on both devices, op for op: the card's sweep equals the
    CPU's bit for bit (an escape-pressure Jet grid and a DDIO one)."""
    from repro_torch.core.simulator import testbed_100g
    from repro_torch.fabric import grid_configs, run_sweep
    cfgs = grid_configs(testbed_100g, mode="jet", sim_time_s=0.002,
                        jet_pool_bytes=[2 << 20, 12 << 20],
                        straggler_frac=[0.05, 0.3],
                        mem_esc_bytes=[0, 2 << 20])[0]
    cfgs += grid_configs(testbed_100g, mode="ddio", sim_time_s=0.002,
                         msg_bytes=[64 << 10, 1 << 20],
                         cpu_membw_gbps=[1200.0, 1900.0])[0]
    got = run_sweep(cfgs)
    want = run_sweep(cfgs, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_routing_grid_on_the_card_matches_cpu_float64(card):
    """All four routing modes x an uplink failure at 50 us, 2 ms: within
    5e-4 of CPU float64 with identical finite masks and reroute counts,
    through 4 grants and 1 admit launch a tick."""
    scens = TSC.routing_grid(
        modes=("static_ecmp", "weighted_ecmp", "adaptive", "spray"),
        fail_at_us=(math.inf, 50.0), burst_mb=1.0, n_senders=4,
        sim_time_s=0.002)[0]
    got, launches, captured = _counted(scens)
    assert launches == captured == {"priority_grants": 8000,
                                    "priority_admit": 2000, "seg_sum": 0}
    want = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    for k in ("flow_goodput_gbps", "flow_completion_us",
              "incast_completion_us", "uplink_util_max"):
        a, b = got[k], want[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=5e-4, atol=0.0), k
    assert np.array_equal(got["reroute_count"], want["reroute_count"])
    assert not np.isfinite(got["incast_completion_us"][4])


def _held_to_cpu(got, want, keys, tol=5e-4):
    for k in keys:
        a, b = got[k], want[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=tol, atol=0.0), k


def test_message_grid_on_the_card_matches_cpu_float64(card):
    """DCQCN, Timely and HPCC x two windows of 16 KB verbs writes, 4
    senders, 1 ms: message counts within 8 a point, p50/p99/p999 within
    one histogram bucket + 2 us, goodput within 5e-4 of CPU float64,
    through 4 grants and 1 admit launch a tick."""
    from repro_torch.fabric.messages import hist_ratio
    scens = TSC.message_sweep_grid(msg_kb=(16.0,), window=(4, 16),
                                   verb=("write",),
                                   algo=("dcqcn", "timely", "hpcc"),
                                   n_senders=4, sim_time_s=0.001)[0]
    got, launches, captured = _counted(scens)
    assert launches == captured == {"priority_grants": 4000,
                                    "priority_admit": 1000, "seg_sum": 0}
    want = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    _held_to_cpu(got, want, ("flow_goodput_gbps",))
    assert np.abs(got["msg_count_total"] - want["msg_count_total"]).max() \
        <= 8
    bucket = hist_ratio() - 1.0
    for k in ("msg_p50_us", "msg_p99_us", "msg_p999_us"):
        assert (np.abs(got[k] - want[k]) <= bucket * want[k] + 2.0).all(), k


def test_lossy_grid_on_the_card_matches_cpu_float64(card):
    """go-back-N and selective recovery at 0.5 % and 2 % loss plus a
    receiver crash, 4 senders, 1 ms: dropped packets and retransmitted
    bytes within 1e-4, message counts within 8, crash recovery within a
    tick and deadlock ticks equal to CPU float64."""
    from repro_torch.fabric.faults import FaultConfig
    scens = TSC.lossy_incast_grid(loss_rate=(0.005, 0.02),
                                  recovery=("go_back_n", "selective"),
                                  n_senders=4, sim_time_s=0.001)[0]
    crash = TSC.lossy_incast(n_senders=4, loss_rate=0.005,
                             recovery="selective", sim_time_s=0.001)
    crash.fabric.faults = FaultConfig(0.005, seed=7).crash("h1_0", 100.0,
                                                          200.0)
    scens.append(crash)
    got, launches, captured = _counted(scens)
    assert launches == captured == {"priority_grants": 4000,
                                    "priority_admit": 1000, "seg_sum": 0}
    want = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    _held_to_cpu(got, want, ("dropped_pkts", "retransmit_bytes"), 1e-4)
    _held_to_cpu(got, want, ("flow_goodput_gbps",))
    assert np.abs(got["msg_count_total"] - want["msg_count_total"]).max() \
        <= 8
    a, b = got["crash_recovery_us"], want["crash_recovery_us"]
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    assert np.abs(a[np.isfinite(b)] - b[np.isfinite(b)]).max() <= 1.0
    assert np.array_equal(got["deadlock_ticks"], want["deadlock_ticks"])


def _incast48(sim_time_s, with_victim=True, bursts=(0.25, 0.5, 0.75, 1.0,
                                                   1.5, 2.0, 2.5, 3.0, 3.5,
                                                   4.0, 5.0, 6.0)):
    """``benchmarks/bench_fabric.py``'s incast grid (8 senders, receiver
    mode x PFC x burst sizes)."""
    return TSC.fabric_grid(
        lambda mode, pfc, burst_mb: TSC.incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            with_victim=with_victim, sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=list(bursts))[0]


def _lossy9(sim_time_s):
    """The bench's faults grid and its crash case."""
    from repro_torch.fabric.faults import FaultConfig
    scens = TSC.lossy_incast_grid(loss_rate=(0.0, 0.002, 0.01, 0.05),
                                  recovery=("go_back_n", "selective"),
                                  sim_time_s=sim_time_s)[0]
    crash = TSC.lossy_incast(loss_rate=0.005, recovery="selective",
                             sim_time_s=sim_time_s)
    crash.fabric.faults = FaultConfig(0.005, seed=7).crash(
        "h1_0", at_us=40.0, restart_us=120.0)
    return scens + [crash]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_sees_every_replayed_water_fill(card):
    """``chip_smoke.py``'s trace of a 2,000-tick incast48 run through the
    graph counts every water-fill a replay executed by name: 8,000 grants
    and 2,000 admits, as the counts kept on the card say.  A session
    without idle time at its edges lost up to 104 ticks' kernels."""
    cs = _chip_smoke()
    run = FabricRun(FabricSweepParams.from_scenarios(_incast48(0.002)))
    fused.reset_launches()
    prof = cs.trace_kernels(run.run)
    want = {"priority_grants": 8000, "priority_admit": 2000, "seg_sum": 0}
    assert fused.LAUNCHES.read() == run.launches_captured() == want
    assert prof["waterfill_launches"] == want


@pytest.mark.parametrize("grid", ["incast48", "lossy9"])
def test_graph_equals_eager_on_the_card(card, grid):
    """The captured chains replay the eager loop's kernels on the same
    shapes in the same order: every output equal, 200 ticks, with 4
    grants and 1 admit counted a tick both ways (the replays' counted on
    the card, equal to the launches captured for a tick x ticks)."""
    scens = (_incast48 if grid == "incast48" else _lossy9)(0.0002)
    want_launches = {"priority_grants": 800, "priority_admit": 200,
                     "seg_sum": 0}
    got, launches, captured = _counted(scens)
    assert launches == captured == want_launches
    want, launches, _ = _counted(scens, graph=False)
    assert launches == want_launches
    assert got.keys() == want.keys()
    for k in want:
        assert _same(got[k], want[k]), k


def test_adaptive_graph_within_bound_of_cpu_float32(card):
    """The adaptive bench grid (victimless incast, 2 bursts) at 2 ms: the
    captured iteration against the port's CPU float32 run of the same
    iteration.  Both are float32, so delivered bytes and goodput agree
    within 5e-4 (the float32 tier), completion times within one stride
    and a tick, and the iteration counts within max_stride (a stride
    decision the two devices' roundings take differently changes the
    count by less than one stride)."""
    cfg = fused.AdaptiveConfig()
    scens = _incast48(0.002, with_victim=False, bursts=(0.25, 0.5))
    got, launches, captured = _counted(scens, adaptive=cfg)
    iters = int(got["adaptive_iterations"][0])
    assert iters < 1000
    assert launches == captured == {"priority_grants": 4 * iters,
                                    "priority_admit": iters, "seg_sum": 0}
    want = run_fabric_sweep(scens, device="cpu", adaptive_dt=True)
    assert abs(iters - int(want["adaptive_iterations"][0])) \
        <= cfg.max_stride
    _held_to_cpu(got, want, ("flow_delivered_bytes", "flow_goodput_gbps"))
    a, b = got["flow_completion_us"], want["flow_completion_us"]
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    m = np.isfinite(b)
    dt_us = FabricSweepParams.from_scenarios(scens).dt_us
    assert (np.abs(a[m] - b[m]) <= (cfg.max_stride + 1) * dt_us).all()


def test_adaptive_max_stride_one_equals_fixed_dt_on_the_card(card):
    scens = _incast48(0.0002)
    fixed = run_fabric_sweep(scens)
    adap = run_fabric_sweep(scens,
                            adaptive=fused.AdaptiveConfig(max_stride=1))
    assert (adap.pop("adaptive_iterations") == 200).all()
    for k in fixed:
        assert _same(adap[k], fixed[k]), k


SEG_SHAPES = [(4, 193, 693), (4, 1158, 693), (4, 193, 231),
              (1, 1, 1), (3, 60000, 5000), (64, 24576, 12291),
              (4096, 24576, 12291), (300, 1001, 77), (200, 40000, 100)]


def _seg_inputs(seed, rows, n, size):
    """Values whose sums depend on the order, one crowded bin, bins with
    no entry."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, size, n)
    idx[: n // 4] = 0
    vals = rng.choice(np.array([1e8, 1.0, -1e8, 0.3, -2.5, 0.0],
                               np.float32), size=(rows, n))
    return torch.from_numpy(vals), idx


@pytest.mark.parametrize("rows,n,size", SEG_SHAPES)
def test_seg_sum_kernel_is_the_cpu_plain_version_bitwise(card, rows, n,
                                                        size):
    """The pod path's shapes, a row past shared memory (60,000 values:
    the device-memory path) and a large one: bit for bit the plain
    version run on the CPU in float32, and the same bits launch after
    launch."""
    vals, idx = _seg_inputs(8, rows, n, size)
    want = fused.seg_sum_ref(vals, torch.from_numpy(idx), size)
    plan = fused.seg_plan(idx, size, card)
    fused.reset_launches()
    got = fused.seg_sum(vals.to(card), plan)
    again = fused.seg_sum(vals.to(card), plan)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["seg_sum"] == 2
    assert _same_bits(got.cpu(), want)
    assert _same_bits(again, got)


def _straddling():
    """A bin of 33 entries and one of 1,000 off the 32-entry chunk edges,
    between short bins, the entries shuffled."""
    rng = np.random.default_rng(7)
    idx = np.concatenate([np.full(5, 0), np.full(33, 1), np.full(1000, 2),
                          rng.integers(3, 40, 300), np.full(31, 41),
                          np.full(32, 42)])
    return rng.permutation(idx), 45


def _slot5():
    """pod1024's slot-5 row: 768 of 769 entries in one bin."""
    idx = np.full(769, 1757)
    idx[300] = 12
    return idx, 2637


SEG_ADVERSARIAL = {
    "one bin holds all": (3, np.zeros(1000, np.int64), 5),
    "empty bins": (3, np.array([1, 4, 4, 1, 7, 4] * 3), 9),
    "no entries": (3, np.zeros(0, np.int64), 3),
    "one bin": (5, np.zeros(50, np.int64), 1),
    "33 and 1000 across chunk edges": (4, *_straddling()),
    "33 and 1000, persistent": (301, *_straddling()),
    "pod1024 slot 5": (4, *_slot5()),
}


def _seg_vals(seed, rows, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(
        np.array([1e8, 1.0, -1e8, 0.3, -2.5, 0.0, -0.0], np.float32),
        size=(rows, n)))


@pytest.mark.parametrize("case", SEG_ADVERSARIAL)
def test_seg_sum_adversarial_bins_bitwise(card, case):
    """Bins that hold every entry, empty bins, no entries, a single bin,
    bins of 33 and 1,000 entries across the warp's chunk edges (in a
    block a row and in persistent blocks), the incast slot row: both
    kernels bit for bit the plain version run on the CPU in float32,
    launch after launch, one launch a call."""
    rows, idx, size = SEG_ADVERSARIAL[case]
    vals = _seg_vals(10, rows, idx.size)
    want = fused.seg_sum_ref(vals, torch.from_numpy(idx), size)
    plan = fused.seg_plan(idx, size, card)
    v = vals.to(card)
    fused.reset_launches()
    got = [fused.seg_sum(v, plan) for _ in range(2)]
    old = fused.seg_sum(v, plan, _variant="bin_thread")
    torch.cuda.synchronize()
    assert fused.LAUNCHES["seg_sum"] == 3
    for g in got + [old]:
        assert _same_bits(g.cpu(), want)


@pytest.mark.parametrize("rows,n,size", SEG_SHAPES)
def test_seg_sum_bin_thread_variant_equals_warp_fold(card, rows, n, size):
    """The first design, forced, gives the new kernel's bits."""
    vals, idx = _seg_inputs(12, rows, n, size)
    plan = fused.seg_plan(idx, size, card)
    v = vals.to(card)
    got = fused.seg_sum(v, plan)
    old = fused.seg_sum(v, plan, _variant="bin_thread")
    torch.cuda.synchronize()
    assert _same_bits(got, old)


def test_seg_sum_captured_launch_equals_eager(card):
    """A launch captured into a CUDA graph and replayed (on new values
    copied into its input) equals an eager launch on those values, and
    each replay counts one launch on the card."""
    idx, size = _straddling()
    plan = fused.seg_plan(idx, size, card)
    static = _seg_vals(13, 4, idx.size).to(card)
    fused.seg_sum(static, plan)                 # eager first: the counter
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused.seg_sum(static, plan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused.seg_sum(static, plan)
    fused.reset_launches()
    for seed in (14, 15):
        fresh = _seg_vals(seed, 4, idx.size).to(card)
        static.copy_(fresh)
        graph.replay()
        eager = fused.seg_sum(fresh, plan)
        torch.cuda.synchronize()
        assert _same_bits(captured, eager)
        assert _same_bits(eager.cpu(), fused.seg_sum_ref(
            fresh.cpu(), torch.from_numpy(idx), size))
    assert fused.LAUNCHES.read()["seg_sum"] == 4


@pytest.mark.parametrize("rows,n,size,n_long,want", [
    # grid, threads, buffers, indices staged, bulk copy
    (4, 1158, 693, 11, (4, 1024, 1, True, False)),      # pod256, all slots
    (4, 4614, 2637, 11, (4, 1024, 1, True, False)),     # pod1024, all slots
    (4, 193, 231, 0, (4, 256, 1, True, False)),         # pod256 slot -> port
    (4, 33, 47, 1, (4, 128, 1, True, False)),           # pod64 slot 5 -> port
    (4096, 24576, 12291, 0, (132, 1024, 2, False, True)),   # the large check
    (300, 1001, 77, 1, (132, 1024, 2, True, True)),     # persistent, unaligned
    (200, 40000, 100, 0, (132, 1024, 1, False, True)),  # one buffer fits
    (3, 60000, 5000, 0, (3, 1024, 0, False, False)),    # past shared memory
    (1, 1, 1, 0, (1, 128, 1, True, False)),
    (500, 7, 3, 0, (132, 1024, 1, True, False)),        # no bulk copy below 8
])
def test_seg_sum_launch_layout(card, rows, n, size, n_long, want):
    """The launch the C source makes on a card of 132 SMs: its choices,
    and its shared memory (two mbarriers, the row buffers, 512 bytes a
    warp that folds a long bin, perm where staged) within the 227 KB a
    block may opt into."""
    got = fused.seg_launch(rows, n, size, n_long, sms=132)
    assert (got["grid"], got["threads"], got["buffers"],
            got["indices_staged"], got["tma"]) == want
    row_bytes = 4 * ((n + 7) // 4 * 4)
    assert got["smem_bytes"] == 16 + got["buffers"] * row_bytes + 512 * min(
        n_long, got["threads"] // 32) + (
        4 * n if got["indices_staged"] else 0)
    assert got["smem_bytes"] <= 232448


def test_seg_sum_wrapper_rejects_what_the_kernel_does_not_take(card):
    vals, idx = _seg_inputs(9, 2, 50, 7)
    plan = fused.seg_plan(idx, 7, card)
    with pytest.raises(TypeError):
        fused.seg_sum(vals.double().to(card), plan)
    with pytest.raises(ValueError):
        fused.seg_sum(vals[:, :40].to(card), plan)
    with pytest.raises(ValueError):
        fused.seg_sum(vals.to(card), fused.seg_plan(idx, 7))
    with pytest.raises(ValueError):
        fused.seg_sum(vals.to(card), plan, _variant="tree")


def _pod64(sim_time_s):
    """``benchmarks/bench_fabric.py``'s small scale point: receiver mode
    x PFC, 2 x 2 x 16 hosts, 0.2 MB bursts."""
    return TSC.pod_incast_grid(pods=2, leaves_per_pod=2, hosts_per_leaf=16,
                               burst_mb=0.2, sim_time_s=sim_time_s)[0]


def _counted_sparse(scens, **kw):
    run = FabricRun(FabricSweepParams.from_scenarios(scens, sparse=True),
                    **kw)
    fused.reset_launches()
    res = run.run()
    return res, fused.LAUNCHES.read(), run.launches_captured()


def test_pod_grid_graph_equals_eager_on_the_card(card):
    """pod64 at 200 ticks through the captured graph and the eager loop:
    every output equal, with 6 grants, 1 admit and 22 segment sums a
    tick counted both ways (the replays' counted on the card, equal to
    the launches captured for a tick x ticks); within 5e-4 of CPU
    float64."""
    scens = _pod64(0.0002)
    want_launches = {"priority_grants": 1200, "priority_admit": 200,
                     "seg_sum": 4400}
    got, launches, captured = _counted_sparse(scens)
    assert launches == captured == want_launches
    eager, launches, _ = _counted_sparse(scens, graph=False)
    assert launches == want_launches
    assert got.keys() == eager.keys()
    for k in eager:
        assert _same(got[k], eager[k]), k
    cpu = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    _held_to_cpu(got, cpu, ("flow_goodput_gbps", "flow_completion_us",
                            "ecn_marked_bytes", "uplink_util_max"))


def test_sparse_two_tier_is_the_dense_run_on_the_card(card):
    """incast48's 2-tier grid through the sparse engine: within 5e-4 of
    the dense engine's card run, with identical finite masks (cuBLAS
    sums the dense engine's one-hot products in its own order)."""
    scens = _incast48(0.0002)
    dense = run_fabric_sweep(scens)
    sparse = run_fabric_sweep(scens, incidence="sparse")
    _held_to_cpu(sparse, dense, ("flow_goodput_gbps", "flow_completion_us",
                                 "incast_completion_us",
                                 "switch_dropped_bytes"))


# --------------------------------------------------------------------------- #
# the sweep farm: captured runs re-armed per chunk
# --------------------------------------------------------------------------- #
def test_farm_equals_monolithic_on_the_card(card):
    """A 7-point incast grid in chunks of 4 (4, then 3 padded to 4 by a
    repeated lane): every output equal to the monolithic graph run, NaN
    and inf in the same places; a second pass captures no graph and
    counts 4 grants and 1 admit a tick on the card in each chunk, equal
    to the launches captured x ticks."""
    from repro_torch.fabric.farm import run_farm
    scens = TSC.incast_grid(burst_mb=(0.5, 1.0), n_senders=4,
                            sim_time_s=0.0005)[0][:7]
    mono = run_fabric_sweep(scens)
    first = run_farm(scens, chunk_size=4, artifacts=False)
    again = run_farm(scens, chunk_size=4, artifacts=False)
    for farm in (first, again):
        assert farm["results"].keys() == mono.keys()
        for k in mono:
            assert _same(farm["results"][k], mono[k]), k
    recs = again["manifest"]["records"]
    assert [(r["stop"] - r["start"], r["padded"]) for r in recs] == \
        [(4, 4), (3, 4)]
    assert [r["captures"] for r in recs] == [0, 0]
    want = {"priority_grants": 2000, "priority_admit": 500, "seg_sum": 0}
    for r in recs:
        assert r["launches"] == r["launches_captured"] == want


@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs two or more cards")
def test_farm_round_robin_over_cards_equals_monolithic(card):
    """With ``device="cuda"`` (no index) the chunks take the cards in
    turn: a 4-point grid in chunks of 2 runs its two chunks on cards 0
    and 1, and every output equals the monolithic run on card 0."""
    from repro_torch.fabric.farm import run_farm
    scens = TSC.incast_grid(burst_mb=(0.5,), n_senders=4,
                            sim_time_s=0.0005)[0]
    mono = run_fabric_sweep(scens, device="cuda:0")
    farm = run_farm(scens, chunk_size=2, device="cuda", artifacts=False)
    assert [r["device"] for r in farm["manifest"]["records"]] == \
        ["cuda:0", "cuda:1"]
    assert farm["results"].keys() == mono.keys()
    for k in mono:
        assert _same(farm["results"][k], mono[k]), k


def test_capture_runs_with_the_garbage_collector_off(card):
    """Destroying a CUDA graph while another is captured invalidates that
    capture (CUDA refuses the graph's reset on a capturing stream), and a
    cyclic collection may destroy a dead run's graphs at any allocation:
    ``TickChain`` captures with the collector off, warms up and returns
    with it on, and the captured chain still runs."""
    seen = []

    def body(s):
        seen.append(gc.isenabled())
        return {"x": s["x"] + 1.0}

    assert gc.isenabled()
    chain = TickChain(body, {"x": torch.zeros(4, device=card)}, (), 3,
                      capture=True)
    assert gc.isenabled()
    assert seen == [True, True] + [False] * 4     # warm-up, 1, chain of 3
    chain.run(7)
    torch.cuda.synchronize()
    assert chain.state["x"].tolist() == [7.0] * 4


@pytest.mark.parametrize("grid", ["dense", "pods"])
def test_load_into_a_captured_run_equals_a_fresh_capture(card, grid):
    """A captured run re-armed with another chunk of its structure
    (``FabricRun.load``: receiver mode, PFC and the CC differ) replays
    that chunk's run: every output equal to a fresh capture's."""
    if grid == "dense":
        scens = [TSC.incast(4, mode=m, burst_mb=1.0, pfc=p,
                            sim_time_s=0.0003)
                 for m, p in (("jet", False), ("jet", False),
                              ("ddio", True), ("ddio", True))]
        scens[3].fabric.cc = CcConfig(algo="timely")
    else:
        scens = TSC.pod_incast_grid(hosts_per_leaf=2, burst_mb=0.2,
                                    sim_time_s=0.0003)[0]
    sparse = grid == "pods"
    env = FabricSweepParams.from_scenarios(scens, sparse=sparse).envelope()
    a = FabricSweepParams.from_scenarios(scens[:2], sparse=sparse,
                                         envelope=env)
    b = FabricSweepParams.from_scenarios(scens[2:], sparse=sparse,
                                         envelope=env)
    run = FabricRun(a)
    run.run()
    graphs = run.chain.graphs
    run.load(b)
    got = run.run()
    assert run.chain.graphs is graphs
    want = FabricRun(b).run()
    assert got.keys() == want.keys()
    for k in want:
        assert _same(got[k], want[k]), k


# --------------------------------------------------------------------------- #
# flash attention and the SSD scan
# --------------------------------------------------------------------------- #
# (b, hq, hkv, t, s, d, causal, window, dtype): the serve path's causal
# MHA, GQA + window in bfloat16 at danube's head dim 80, non-causal T < S,
# causal T < S, ragged tiles, head dim 128 in bfloat16, gemma-7b's head dim
# 256 in both types, a head dim of 24 (bfloat16 rows zero-padded to 32
# bytes), a group of 8 at head dim 128 in float32, and head dims of 20 and
# 100 in both types (not multiples of 8: the CUDA-core kernel at both of
# its widths, D <= 64 and D <= 128)
FLASH = [(1, 32, 32, 1024, 1024, 64, True, None, torch.float32),
         (1, 32, 8, 300, 300, 80, True, 64, torch.bfloat16),
         (2, 8, 8, 100, 333, 64, False, None, torch.float32),
         (2, 8, 2, 37, 150, 32, True, None, torch.float32),
         (1, 4, 1, 65, 65, 16, True, 3, torch.float32),
         (1, 2, 2, 130, 130, 128, True, None, torch.bfloat16),
         (1, 16, 16, 300, 300, 256, True, None, torch.bfloat16),
         (1, 16, 16, 300, 300, 256, True, None, torch.float32),
         (1, 4, 2, 100, 100, 24, True, None, torch.bfloat16),
         (1, 16, 2, 200, 200, 128, True, None, torch.float32),
         (1, 4, 4, 70, 70, 20, True, None, torch.float32),
         (1, 4, 2, 70, 70, 20, True, 16, torch.bfloat16),
         (1, 4, 2, 130, 200, 100, True, None, torch.float32),
         (1, 4, 1, 130, 130, 100, False, None, torch.bfloat16),
         # llama-3.2-vision's cross-attention over 1,600 patches
         (1, 32, 8, 256, 1600, 128, False, None, torch.float32),
         (1, 32, 8, 1024, 1600, 128, False, None, torch.bfloat16)]


def _close(got, want, tol):
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window,dtype", FLASH)
def test_flash_kernel_matches_plain(card, b, hq, hkv, t, s, d, causal,
                                    window, dtype):
    g = torch.Generator(device=card).manual_seed(t + s)
    q = torch.randn((b, hq, t, d), generator=g, device=card).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=card).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=card).to(dtype)
    ops.reset_launches()
    jfa.VARIANT_LAUNCHES.reset()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and got.dtype == dtype
    # head dims of 16-byte rows run on the tensor cores, the rest on the
    # CUDA cores
    ran = "simt" if d % 8 else \
        "mma_bf16" if dtype == torch.bfloat16 else "mma_3xtf32"
    assert {n: c for n, c in jfa.VARIANT_LAUNCHES.items() if c} == {ran: 1}
    _close(got, want, 2e-4 if dtype == torch.float32 else 5e-2)
    if dtype == torch.bfloat16:
        # the kernels round only P (mma_bf16) and the output: the H100
        # reads at most one bfloat16 ulp of the largest output (PERF.md §2)
        top = float(want.float().abs().max())
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(
            math.log2(top))
        assert float((got.float() - want.float()).abs().max()) <= ulp


# (B, T, H, P, G, N, chunk, dtype, a_min, dt_shift): the serve path's shape
# and its widths at T = 256 (one chunk) and 512; G < H with several chunks
# at small and at the serve widths; one short chunk (L = 20, a ragged row
# tile); bfloat16; a strongly decaying head set (a down to -64, dt ~ 0.002:
# exp(cum) underflows within a chunk); widths of 128 (the wider tiles, c
# fragments reloaded from shared memory) and mixed tiles with a ragged
# second row tile; N or P not a multiple of 8 on simt, in both types
SSD = [(1, 1024, 64, 64, 1, 64, 256, torch.float32, -8.0, -3.0),
       (1, 256, 64, 64, 1, 64, 256, torch.float32, -8.0, -3.0),
       (1, 512, 64, 64, 1, 64, 256, torch.float32, -8.0, -3.0),
       (2, 96, 8, 32, 2, 16, 32, torch.float32, -8.0, -3.0),
       (1, 512, 16, 64, 2, 64, 128, torch.float32, -8.0, -3.0),
       (1, 20, 4, 16, 1, 8, 256, torch.float32, -8.0, -3.0),
       (1, 128, 8, 64, 1, 64, 64, torch.bfloat16, -8.0, -3.0),
       (1, 256, 8, 64, 1, 64, 256, torch.float32, -64.0, -6.0),
       (1, 256, 4, 128, 1, 128, 256, torch.float32, -8.0, -3.0),
       (2, 192, 4, 128, 1, 32, 64, torch.float32, -8.0, -3.0),
       (1, 192, 4, 32, 1, 128, 96, torch.float32, -8.0, -3.0),
       (1, 128, 4, 20, 1, 64, 64, torch.float32, -8.0, -3.0),
       (1, 64, 4, 24, 1, 12, 32, torch.bfloat16, -8.0, -3.0)]


@pytest.mark.parametrize("B,T,H,P,G,N,chunk,dtype,a_min,dt_shift", SSD)
def test_ssd_kernel_matches_plain(card, B, T, H, P, G, N, chunk, dtype,
                                  a_min, dt_shift):
    g = torch.Generator(device=card).manual_seed(T)
    x = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device=card) * 0.5 + dt_shift)
    a = -torch.linspace(1.0, -a_min, H, device=card)
    b = torch.randn((B, T, G, N), generator=g, device=card).to(dtype)
    c = torch.randn((B, T, G, N), generator=g, device=card).to(dtype)
    dt = dt.to(dtype)
    ops.reset_launches()
    mssd.VARIANT_LAUNCHES.reset()
    y, h = ops.ssd(x, dt, a, b, c, chunk=chunk)
    y0, h0 = ops.ssd(x, dt, a, b, c, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    # widths of 16-byte rows up to 128 run the tensor-core passes, the rest
    # the CUDA cores
    ran = "mma_3xtf32" if N % 8 == 0 and P % 8 == 0 and max(N, P) <= 128 \
        else "simt"
    assert {n: k for n, k in mssd.VARIANT_LAUNCHES.items() if k} == {ran: 1}
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    _close(y, y0, tol)
    _close(h, h0, tol)


def test_ssd_simt_forced_matches_plain(card):
    # the first kernel (simt), forced at the serve path's widths
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((1, 512, 8, 64), generator=g, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn((1, 512, 8), generator=g, device=card) * 0.5 - 3.0)
    a = -torch.linspace(1.0, 8.0, 8, device=card)
    b = torch.randn((1, 512, 1, 64), generator=g, device=card)
    c = torch.randn((1, 512, 1, 64), generator=g, device=card)
    mssd.VARIANT_LAUNCHES.reset()
    y, h = mssd.ssd_scan(x, dt, a, b, c, 256, _variant="simt")
    y0, h0 = ops.ssd(x, dt, a, b, c, chunk=256, impl="ref")
    torch.cuda.synchronize()
    assert dict(mssd.VARIANT_LAUNCHES) == {"mma_3xtf32": 0, "simt": 1}
    _close(y, y0, 2e-4)
    _close(h, h0, 2e-4)


@pytest.mark.parametrize("name,n,p,chunk", [
    ("mma_3xtf32", 64, 64, 256), ("mma_3xtf32", 8, 72, 20),
    ("mma_3xtf32", 128, 64, 80), ("mma_3xtf32", 128, 128, 64),
    ("simt", 64, 20, 256), ("simt", 12, 24, 32)])
def test_ssd_launch_plan_is_the_python_plan(card, name, n, p, chunk):
    # what the C launchers ask for (ssd_scan_plan) against smem_bytes, the
    # Python plan the CPU tests hold to 227 KB
    plan = mssd.plan(name, 2, 4 * chunk, 3, n, p, chunk)
    assert list(plan) == list(mssd.KERNELS[name])
    assert max(s for s, _ in plan.values()) == mssd.smem_bytes(
        name, n, p, chunk)
    if name == "mma_3xtf32":    # per (b, h, chunk); per element; per row tile
        assert plan["ssd_state_kernel"][1] == 2 * 3 * 4
        assert plan["ssd_carry_kernel"] == (0, -(-2 * 3 * n * p // 256))
        assert plan["ssd_output_kernel"][1] == 2 * 3 * 4 * -(-chunk // 64)
    else:
        assert plan["ssd_simt_kernel"][1] == 2 * 3


def test_model_kernel_wrappers_reject_what_they_do_not_take(card):
    q = torch.zeros((1, 4, 8, 16), device=card)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 2, 8, 264), device=card)
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                            q.transpose(2, 3))
    # N = 130 is no multiple of 8, so simt takes it, and simt holds the
    # whole 512-row chunk in shared memory
    x = torch.zeros((1, 512, 4, 128), device=card)
    bc = torch.zeros((1, 512, 1, 130), device=card)
    dt = torch.zeros((1, 512, 4), device=card)
    a = torch.zeros(4, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd(x, dt, a, bc, bc, chunk=512)
    with pytest.raises(ValueError, match="does not take"):
        mssd.ssd_scan(x, dt, a, bc, bc, 512, _variant="mma_3xtf32")
    # 16-byte rows are what the tensor-core passes stage by cp.async
    x = torch.zeros((1, 64, 4, 65), device=card)[..., 1:]
    bc = torch.zeros((1, 64, 1, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd(x, dt[:, :64], a, bc, bc, chunk=64)
    xa = torch.zeros(1 * 64 * 4 * 64 + 1, device=card)[1:].view(1, 64, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd(xa, dt[:, :64].contiguous(), a, bc, bc, chunk=64)


def test_tiny_zamba2_prefill_runs_through_the_kernels(card):
    cfg = tiny_config(get_arch("zamba2-1.2b"))
    params = api.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                             device=card)
    tok = torch.randint(2, cfg.vocab_size, (2, 64), device=card)
    ops.reset_launches()
    lk, sk, _ = api.prefill(params, cfg, tok, max_len=80)
    assert ops.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 0,
                            "ssd_scan": 7, "decode_attention_paged": 0,
                            "staged_matmul": 0}
    lr, sr, _ = api.prefill(params, cfg, tok, max_len=80, impl="ref")
    assert float((lk - lr).abs().max() / lr.abs().max()) <= 2e-3


@pytest.mark.parametrize("arch", [
    "chatglm3-6b", "gemma-7b", "h2o-danube-1.8b", "starcoder2-15b",
    "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "xlstm-125m"])
def test_tiny_family_prefill_and_decode_run_on_the_card(card, arch):
    """Each engine-served family at its tiny size: a prefill launches
    flash attention once an attention layer (none in xLSTM) and matches
    the plain versions within 2e-3; two decode steps stay finite."""
    from repro_torch.models.transformer import layer_kinds
    cfg = tiny_config(get_arch(arch))
    params = api.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                             device=card)
    tok = torch.randint(2, cfg.vocab_size, (2, 128), device=card)
    ops.reset_launches()
    lk, sk, lens = api.prefill(params, cfg, tok, max_len=136)
    n_attn = sum(k.startswith("attn") for k in layer_kinds(cfg))
    assert ops.LAUNCHES["flash_attention"] == n_attn
    lr, _, _ = api.prefill(params, cfg, tok, max_len=136, impl="ref")
    assert float((lk - lr).abs().max() / lr.abs().max()) <= 2e-3
    step = torch.argmax(lk, -1).to(torch.int32)
    for _ in range(2):
        logits, sk = api.decode_step(params, cfg, sk, step, lens)
        assert bool(torch.isfinite(logits).all())
        step, lens = torch.argmax(logits, -1).to(torch.int32), lens + 1


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_tiny_cross_and_codebook_prefill_run_on_the_card(card, arch):
    """Tiny vision (two rows, two images) and tiny musicgen ([2, 4, T]
    codebook tokens): a prefill launches flash attention once a self-
    and once a cross-attention layer and matches the plain versions
    within 2e-3, logits and states; ``forward``'s last logits equal the
    prefill's; a decode step stays finite."""
    from repro_torch.models.decoding import tree_map
    from repro_torch.models.transformer import layer_kinds
    cfg = tiny_config(get_arch(arch))
    gen = torch.Generator(device=card).manual_seed(0)
    params = api.init_params(cfg, gen, device=card)
    batch = api.synthetic_inputs(cfg, ShapeConfig("t", "prefill", 128, 2),
                                 gen, torch.float32, card)
    tok, patches = batch["tokens"], batch.get("patches")
    kinds = layer_kinds(cfg)
    ops.reset_launches()
    lk, sk, lens = api.prefill(params, cfg, tok, patches, max_len=136)
    assert ops.LAUNCHES["flash_attention"] == len(kinds) + kinds.count(
        "attn_cross")
    lr, sr, _ = api.prefill(params, cfg, tok, patches, max_len=136,
                            impl="ref")
    worst = []
    tree_map(lambda g, w: worst.append(float(
        (g - w).abs().max() / w.abs().max().clamp_min(1e-30))), sk, sr)
    assert float((lk - lr).abs().max() / lr.abs().max()) <= 2e-3
    assert max(worst) <= 2e-3
    full, _ = api.forward(params, cfg, tok, patches)
    assert float((full[:, -1] - lk).abs().max() / lk.abs().max()) <= 2e-3
    step = torch.argmax(lk, -1).to(torch.int32)
    if cfg.num_codebooks:
        step = step[:, None].repeat(1, cfg.num_codebooks)
    logits, _ = api.decode_step(params, cfg, sk, step, lens)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("tokens,cf", [(512, 1.25), (4, 1.25), (512, 4.0)])
def test_moe_dispatch_equals_dense_ref_on_the_card(card, tokens, cf):
    """The capacity dispatch against every expert on every token, on the
    card: output within 2e-4 of the largest magnitude, the same tokens
    kept, the same overflow."""
    import dataclasses
    from repro_torch.models import moe
    cfg = dataclasses.replace(tiny_config(get_arch("llama4-scout-17b-a16e")),
                              num_experts=16)
    g = torch.Generator(device=card).manual_seed(tokens)
    p = moe.moe_init(g, cfg, device=card)
    x = torch.randn((1, tokens, cfg.d_model), generator=g, device=card)
    routes = []
    y, aux = moe.moe_apply(p, x, cfg, cf, on_route=lambda *r: routes.append(r))
    yr, auxr = moe.moe_dense_ref(p, x, cfg, cf,
                                 on_route=lambda *r: routes.append(r))
    assert float((y - yr).abs().max()) <= 2e-4 * float(yr.abs().max())
    (i, k, _), (ir, kr, _) = routes
    assert torch.equal(i, ir) and torch.equal(k, kr)
    assert float(aux["overflow"]) == float(auxr["overflow"])
    if tokens == 512:       # 40 slots an expert overflow, 128 do not
        assert (float(aux["overflow"]) > 0) == (cf < 4.0)


# --------------------------------------------------------------------------- #
# paged decode attention and the staged matmul
# --------------------------------------------------------------------------- #
def _paged(card, b, hq, hkv, d, page, lengths, q_dtype, kv_dtype, seed):
    """Seeded pages and a shuffled page table with -1 past each length."""
    rng = np.random.default_rng(seed)
    need = [-(-n // page) for n in lengths]
    maxp, n_pool = max(max(need), 1), sum(need) + 3
    perm = rng.permutation(n_pool)
    table = np.full((b, maxp), -1, np.int32)
    at = 0
    for i, k in enumerate(need):
        table[i, :k] = perm[at:at + k]
        at += k
    g = torch.Generator(device=card).manual_seed(seed)
    kp = torch.randn((n_pool, page, hkv, d), generator=g, device=card)
    vp = torch.randn((n_pool, page, hkv, d), generator=g, device=card)
    q = torch.randn((b, hq, d), generator=g, device=card)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype),
            torch.from_numpy(table).to(card),
            torch.tensor(lengths, dtype=torch.int32, device=card))


# (b, hq, hkv, d, page, lengths, q dtype, page dtype): zamba2's shared
# attention, danube's group of 4 at head dim 80, starcoder2's group of 12
# in bfloat16, a page longer than the 64-position tile, mixed types,
# gemma-7b's 16 heads of 256 in bfloat16, head dim 256 in float32, groups
# of 32 (two head tiles) in every variant
PAGED = [(6, 32, 32, 64, 16, [64, 128, 256, 512, 1024, 256],
          torch.float32, torch.float32),
         (4, 32, 8, 80, 32, [4096, 1, 777, 3000], torch.float32,
          torch.float32),
         (8, 48, 4, 128, 16, [1, 17, 300, 1000, 2048, 4097, 6000, 8192],
          torch.bfloat16, torch.bfloat16),
         (3, 8, 1, 32, 100, [250, 99, 101], torch.float32, torch.float32),
         (2, 16, 2, 64, 8, [37, 64], torch.float32, torch.bfloat16),
         (8, 16, 16, 256, 16, [1, 300, 1000, 2048, 4096, 4097, 6000, 8192],
          torch.bfloat16, torch.bfloat16),
         (3, 16, 16, 256, 16, [1, 300, 1000], torch.float32, torch.float32),
         (2, 64, 2, 128, 16, [300, 1000], torch.bfloat16, torch.bfloat16),
         (2, 64, 2, 256, 16, [77, 513], torch.float32, torch.bfloat16),
         (2, 64, 2, 64, 16, [77, 513], torch.bfloat16, torch.float32)]


def _decode_variant(q_dtype, kv_dtype):
    """The variant the types must take: float32 pages on the CUDA cores,
    bfloat16 pages on mma.sync, split into two bfloat16 halves where q is
    float32."""
    if kv_dtype == torch.float32:
        return "simt_f32"
    return "mma_bf16" if q_dtype == torch.bfloat16 else "mma_bf16x2"


@pytest.mark.parametrize("b,hq,hkv,d,page,lengths,q_dtype,kv_dtype", PAGED)
def test_paged_decode_kernel_matches_plain(card, b, hq, hkv, d, page,
                                           lengths, q_dtype, kv_dtype):
    q, kp, vp, table, lens = _paged(card, b, hq, hkv, d, page, lengths,
                                    q_dtype, kv_dtype, b * 100 + page)
    ops.reset_launches()
    jda.VARIANT_LAUNCHES.reset()
    o, lse = ops.decode_attention(q, kp, vp, table, lens)
    o0, lse0 = ops.decode_attention(q, kp, vp, table, lens, impl="ref")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention_paged"] == 1
    assert jda.VARIANT_LAUNCHES == {
        **dict.fromkeys(jda.VARIANT_LAUNCHES, 0),
        _decode_variant(q_dtype, kv_dtype): 1}
    assert o.dtype == q_dtype and lse.dtype == torch.float32
    _close(o, o0, 2e-4 if q_dtype == torch.float32 else 1e-2)
    _close(lse, lse0, 2e-4)


# forced split counts: one (no merge), two, and more splits than the table
# has 64-position tiles (the splits past it are empty), at a page shorter
# than a tile (8), a page longer than one (100: splits start mid-page),
# with a hole where the second split starts and a length-0 row
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("page,splits", [(8, 1), (8, 2), (8, 40), (100, 2),
                                         (100, 7)])
def test_paged_decode_forced_splits_match_plain(card, q_dtype, kv_dtype,
                                                page, splits):
    lengths = [250, 99, 0, 130]
    q, kp, vp, table, lens = _paged(card, 4, 8, 2, 64, page, lengths,
                                    q_dtype, kv_dtype, 11 * page + splits)
    sms = jda.sm_count(torch.cuda.current_device())
    pl = jda.plan(q_dtype, kv_dtype, 4, 8, 2, 64, page, table.shape[1], sms,
                  splits)
    assert pl["splits"] == splits
    assert pl == jda.split_plan(q_dtype, kv_dtype, 4, 8, 2, 64, page,
                                table.shape[1], sms, splits)
    # a hole at the first position of the second split
    at = pl["chunk"] // page
    if at < table.shape[1]:
        table[0, at] = -1
    o, lse = jda.decode_attention_paged(q, kp, vp, table, lens,
                                        splits=splits)
    o0, lse0 = ops.decode_attention(q, kp, vp, table, lens, impl="ref")
    torch.cuda.synchronize()
    assert bool((o[2] == 0).all())            # the reference kernel's value
    live = lens > 0
    _close(o[live], o0[live], 2e-4 if q_dtype == torch.float32 else 1e-2)
    _close(lse, lse0, 2e-4)


def test_paged_decode_length_zero_row_gives_zero(card):
    q, kp, vp, table, lens = _paged(card, 3, 8, 2, 64, 16, [0, 16, 100],
                                    torch.float32, torch.float32, 5)
    o, lse = ops.decode_attention(q, kp, vp, table, lens)
    o0, lse0 = ops.decode_attention(q, kp, vp, table, lens, impl="ref")
    torch.cuda.synchronize()
    assert bool((o[0] == 0).all())            # the reference kernel's value
    _close(o[1:], o0[1:], 2e-4)
    _close(lse, lse0, 2e-4)


def _close_to_scale(got, want, tol):
    """max |got - want| <= tol * max |want|: two float32 sums of K
    products in different orders differ by ~sqrt(K) roundings of the
    partial sums, which an element whose sum cancels cannot absorb
    relative to itself."""
    assert torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


# (m, k, n, dtype): zamba2's MLP up-projection at a short prefill, ragged
# edges on every axis (scalar loads), a single row; bfloat16 with K and N
# multiples of 8 (the wgmma kernel): M not a multiple of 128, N not a
# multiple of 128, K not a multiple of 64, K = 8, M = 1, and zamba2's
# up-projection at a 1024-token prefill (128 x 256 tiles); bfloat16
# unaligned (the mma.sync kernel)
MATMUL = [(256, 2048, 8192, torch.float32), (1000, 2050, 1000, torch.float32),
          (1, 7, 3, torch.float32), (256, 2048, 8192, torch.bfloat16),
          (100, 130, 70, torch.bfloat16), (17, 65, 33, torch.bfloat16),
          (200, 2048, 8192, torch.bfloat16), (256, 512, 264, torch.bfloat16),
          (128, 72, 128, torch.bfloat16), (64, 8, 256, torch.bfloat16),
          (1, 256, 512, torch.bfloat16), (1024, 2048, 8192, torch.bfloat16)]


def _variant(m, k, n, dtype):
    """The kernel a shape must take: TMA needs 16-byte row strides, so
    bfloat16 goes to wgmma when K and N are multiples of 8, in 128 x 256
    tiles when they make a full wave on 132 SMs."""
    if dtype == torch.float32:
        return "simt_f32"
    if k % 8 or n % 8:
        return "mma_sync_bf16"
    wide = -(-m // 128) * -(-n // 256)
    return "wgmma_bf16_n256" if wide >= 132 else "wgmma_bf16"


@pytest.mark.parametrize("m,k,n,dtype", MATMUL)
def test_staged_matmul_kernel_matches_plain(card, m, k, n, dtype):
    g = torch.Generator(device=card).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=card).to(dtype)
    b = torch.randn((k, n), generator=g, device=card).to(dtype)
    ops.reset_launches()
    jsm.VARIANT_LAUNCHES.reset()
    got = ops.staged_matmul(a, b)
    want = ops.staged_matmul(a, b, impl="ref")
    f32 = ops.staged_matmul(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["staged_matmul"] == 2
    assert jsm.VARIANT_LAUNCHES == {**dict.fromkeys(jsm.VARIANT_LAUNCHES, 0),
                                    _variant(m, k, n, dtype): 2}
    assert got.dtype == dtype and f32.dtype == torch.float32
    _close_to_scale(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
    _close_to_scale(f32, a.float() @ b.float(), 1e-4)


# small-integer operands (|x| <= 4): every float32 sum is exact, so the
# kernel must equal the plain version bit for bit in both output types.
# One 128 x 64 x 128 tile (a wrong shared-memory descriptor shows as values
# in the wrong places), many trips round the stage ring, ragged edges,
# and 128 x 256 tiles (1024 x 8192 outputs)
MATMUL_EXACT = [(128, 64, 128), (128, 640, 128), (256, 2048, 512),
                (200, 2048, 8192), (256, 512, 264), (128, 72, 128),
                (64, 8, 256), (1, 256, 512), (1000, 2056, 1000),
                (1024, 640, 8192), (1000, 2056, 8200)]


@pytest.mark.parametrize("m,k,n", MATMUL_EXACT)
def test_staged_matmul_wgmma_is_exact_on_small_integers(card, m, k, n):
    full_fp32_matmul()
    g = torch.Generator(device=card).manual_seed(m * 3 + k + n)
    a = torch.randint(-4, 5, (m, k), generator=g, device=card).bfloat16()
    b = torch.randint(-4, 5, (k, n), generator=g, device=card).bfloat16()
    jsm.VARIANT_LAUNCHES.reset()
    for out_dtype in (torch.bfloat16, torch.float32):
        got = ops.staged_matmul(a, b, out_dtype=out_dtype)
        want = ops.staged_matmul(a, b, out_dtype=out_dtype, impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert torch.equal(got, want), out_dtype
    assert jsm.VARIANT_LAUNCHES[_variant(m, k, n, torch.bfloat16)] == 2


def test_paged_and_matmul_wrappers_reject_what_they_do_not_take(card):
    q, kp, vp, table, lens = _paged(card, 2, 4, 2, 64, 16, [5, 40],
                                    torch.float32, torch.float32, 6)
    with pytest.raises(TypeError):
        ops.decode_attention(q.half(), kp, vp, table, lens)
    with pytest.raises(TypeError):
        ops.decode_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[..., :6].contiguous(), kp[..., :6].contiguous(),
                             vp[..., :6].contiguous(), table, lens)
    wide = [torch.zeros(t.shape[:-1] + (264,), device=card)
            for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(*wide, table, lens)
    with pytest.raises(ValueError, match="multiple"):
        ops.decode_attention(q[:, :3].contiguous(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, kp, vp, table.t().contiguous().t(), lens)
    a = torch.zeros((8, 16), device=card)
    with pytest.raises(TypeError):
        ops.staged_matmul(a, a.T.contiguous().bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.staged_matmul(a.T, a)
    with pytest.raises(TypeError, match="block_n"):
        ops.staged_matmul(a, a.T.contiguous(), block_n=128)


# --------------------------------------------------------------------------- #
# training: the flash attention backward and the train step
# --------------------------------------------------------------------------- #
# (b, hq, hkv, t, s, d, causal, window, dtype): the train path's danube
# shape, a window that binds, vision's cross-attention (non-causal T < S),
# MHA at head dim 64, gemma-7b's 256 in bfloat16 and in float32 (the
# 32-row tiles), causal T < S, a ragged GQA case at head dim 32, and
# danube's widths in bfloat16
FLASH_BWD = [(2, 32, 8, 4096, 4096, 80, True, 4096, torch.float32),
             (1, 32, 8, 1024, 1024, 80, True, 256, torch.float32),
             (1, 32, 8, 1024, 1600, 128, False, None, torch.float32),
             (1, 32, 32, 1024, 1024, 64, True, None, torch.float32),
             (1, 16, 16, 1024, 1024, 256, True, None, torch.bfloat16),
             (1, 4, 4, 300, 300, 256, True, None, torch.float32),
             (1, 4, 2, 100, 333, 64, True, None, torch.float32),
             (2, 8, 2, 77, 77, 32, True, 20, torch.float32),
             (1, 32, 8, 300, 300, 80, True, 64, torch.bfloat16)]
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # of max |g|


def _qkv_do(card, b, hq, hkv, t, s, d, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(dtype)
            for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, t, d))]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window,dtype", FLASH_BWD)
def test_flash_backward_matches_plain(card, b, hq, hkv, t, s, d, causal,
                                      window, dtype):
    from repro_torch.kernels import ref
    q, k, v, do = _qkv_do(card, b, hq, hkv, t, s, d, dtype, t + s + d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    jfa.VARIANT_LAUNCHES.reset()
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    name = jfa.bwd_variant(dtype, d)
    assert name == ("bwd_mma_bf16" if dtype == torch.bfloat16
                    else "bwd_mma_3xtf32")
    assert jfa.VARIANT_LAUNCHES[name] == 1
    assert jfa.VARIANT_LAUNCHES["bwd_simt"] == 0
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal, window)
    for gk, gp in zip(got, want):
        assert gk.dtype == dtype and torch.isfinite(gk).all()
        err = float((gk.float() - gp.float()).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(gp.float().abs().max())


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window,dtype", [
    FLASH_BWD[1], FLASH_BWD[4], FLASH_BWD[7]])
def test_flash_backward_simt_forced_matches_plain(card, b, hq, hkv, t, s,
                                                  d, causal, window, dtype):
    """The first design, reached only by asking for it (the timing
    comparison of ``chip_smoke.py``), stays right: a window, bf16 at
    D = 256 and a ragged GQA case."""
    from repro_torch.kernels import ref
    q, k, v, do = _qkv_do(card, b, hq, hkv, t, s, d, dtype, t + s + d)
    o, lse = jfa.flash_attention(q, k, v, causal, window, with_lse=True)
    jfa.VARIANT_LAUNCHES.reset()
    got = jfa.flash_attention_bwd(q, k, v, o, do, lse, causal, window,
                                  variant="bwd_simt")
    torch.cuda.synchronize()
    assert jfa.VARIANT_LAUNCHES["bwd_simt"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal, window)
    for gk, gp in zip(got, want):
        assert gk.dtype == dtype and torch.isfinite(gk).all()
        err = float((gk.float() - gp.float()).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(gp.float().abs().max())
    with pytest.raises(ValueError, match="does not take"):
        jfa.flash_attention_bwd(q, k, v, o, do, lse, causal, window,
                                variant="bwd_mma_bf16"
                                if dtype == torch.float32
                                else "bwd_mma_3xtf32")


@pytest.mark.parametrize("name", ["bwd_mma_3xtf32", "bwd_mma_bf16",
                                  "bwd_simt"])
def test_flash_backward_plan_is_the_c_launchers(card, name):
    """``jet_flash_attention.bwd_plan`` (tiles, shared memory, float32
    flush interval) mirrors the plan the C launcher sizes its launches
    by, at every head-dim tile."""
    for d in (8, 32, 64, 80, 96, 128, 256):
        assert jfa.bwd_plan_c(name, d) == jfa.bwd_plan(name, d)


def test_flash_backward_is_deterministic_and_lse_is_right(card):
    q, k, v, do = _qkv_do(card, 1, 16, 4, 512, 512, 80, torch.float32, 3)
    o, lse = jfa.flash_attention(q, k, v, True, 128, with_lse=True)
    o2 = jfa.flash_attention(q, k, v, True, 128)
    assert torch.equal(o, o2)          # the lse output leaves o alone
    scores = torch.einsum("bhtd,bhsd->bhts", q * 80 ** -0.5,
                          k.repeat_interleave(4, dim=1))
    tt = torch.arange(512, device=card)
    mask = (tt[:, None] >= tt[None, :]) & (tt[:, None] - tt[None, :] < 128)
    want = torch.logsumexp(scores.masked_fill(~mask, -1e30), -1)
    assert float((lse - want).abs().max()) <= 1e-4
    a = jfa.flash_attention_bwd(q, k, v, o, do, lse, True, 128)
    b = jfa.flash_attention_bwd(q, k, v, o, do, lse, True, 128)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_backward_rows_without_a_key_get_zeros(card):
    """Causal with T > S: the first T - S rows see no key.  Their dq is
    zero, and dk, dv equal the plain gradient of the other rows alone."""
    from repro_torch.kernels import ref
    q, k, v, do = _qkv_do(card, 1, 4, 2, 96, 64, 32, torch.float32, 4)
    o, lse = jfa.flash_attention(q, k, v, True, None, with_lse=True)
    dq, dk, dv = jfa.flash_attention_bwd(q, k, v, o, do, lse, True, None)
    assert float(dq[:, :, :32].abs().max()) == 0.0
    do_seen = do.clone()
    do_seen[:, :, :32] = 0.0
    wq, wk, wv = ref.flash_attention_bwd_ref(q, k, v, do_seen, True, None)
    for got, want in ((dq[:, :, 32:], wq[:, :, 32:]), (dk, wk), (dv, wv)):
        assert float((got - want).abs().max()) <= \
            2e-5 * float(want.abs().max())


def test_serve_path_flash_is_unchanged_without_grad(card):
    q, k, v, _ = _qkv_do(card, 1, 8, 2, 256, 256, 64, torch.float32, 5)
    ops.reset_launches()
    jfa.VARIANT_LAUNCHES.reset()
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(True), k, v)
    plain = ops.flash_attention(q.detach(), k, v)
    assert out.grad_fn is None and torch.equal(out, plain)
    assert ops.LAUNCHES["flash_attention"] == 2
    assert ops.LAUNCHES["flash_attention_bwd"] == 0
    assert jfa.VARIANT_LAUNCHES["mma_3xtf32"] == 2
    assert jfa.VARIANT_LAUNCHES["bwd_mma_3xtf32"] == 0
    assert jfa.VARIANT_LAUNCHES["bwd_mma_bf16"] == 0
    assert jfa.VARIANT_LAUNCHES["bwd_simt"] == 0


def test_kernels_without_backward_raise_under_grad_on_the_card(card):
    x = torch.zeros((1, 64, 4, 64), device=card, requires_grad=True)
    dt = torch.zeros((1, 64, 4), device=card)
    a = -torch.ones((4,), device=card)
    bc = torch.zeros((1, 64, 1, 64), device=card)
    with pytest.raises(RuntimeError, match="ssd_scan: .*no backward"):
        ops.ssd(x, dt, a, bc, bc, chunk=64)
    m = torch.zeros((64, 64), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="staged_matmul: .*no backward"):
        ops.staged_matmul(m, m.detach())
    qd, kp, vp, table, lens = _paged(card, 2, 4, 2, 64, 16, [5, 40],
                                     torch.float32, torch.float32, 6)
    with pytest.raises(RuntimeError,
                       match="decode_attention_paged: .*no backward"):
        ops.decode_attention(qd.requires_grad_(True), kp, vp, table, lens)
    with torch.no_grad():               # without grad they run
        ops.ssd(x, dt, a, bc, bc, chunk=64)
        ops.staged_matmul(m, m)
    # an SSD family cannot train on the card yet: it raises, naming it
    cfg = tiny_config(get_arch("zamba2-1.2b"))
    from repro_torch.train import steps
    params = api.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                             device=card)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        steps.loss_and_grads(cfg, params, {"tokens": tok, "targets": tok})


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                                  "llama-3.2-vision-11b"])
def test_tiny_gradients_on_the_card_match_plain(card, arch):
    """The tiny model's loss and gradient through the kernels (flash
    forward and backward) against the plain versions on the card, with
    each remat policy; MoE and cross-attention included."""
    from repro_torch import _tree
    from repro_torch.train import steps
    cfg = tiny_config(get_arch(arch))
    g = torch.Generator(device=card).manual_seed(0)
    params = api.init_params(cfg, g, device=card)
    batch = api.synthetic_inputs(cfg, ShapeConfig("t", "train", 64, 2), g,
                                 torch.float32, card)
    gp, lp, _ = steps.loss_and_grads(cfg, params, batch, impl="ref",
                                     remat="none")
    for remat in ("none", "full", "dots"):
        ops.reset_launches()
        gk, lk, _ = steps.loss_and_grads(cfg, params, batch, remat=remat)
        assert ops.LAUNCHES["flash_attention_bwd"] > 0
        assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
        for x, y in zip(_tree.leaves(gk), _tree.leaves(gp)):
            assert float((x - y).abs().max()) <= \
                1e-4 * float(y.abs().max().clamp(min=1e-30))
