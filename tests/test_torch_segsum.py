"""The sparse tick's deterministic segment sum (``fused.seg_plan``,
``seg_sum_ref``, ``seg_sum``) on the CPU.

* the plain version equals ``np.add.at`` (the reference's numpy
  ``_make_step_sparse.seg_sum``) bit for bit in float32 and float64, on
  values whose sum depends on the order (1e8, 1, -1e8);
* the plan is a *stable* sort by bin with CSR offsets, and summing in
  plan order, as ``csrc/seg_sum.cu`` does (ascending entries a bin, from
  0.0, one rounding an add), gives the plain version's bits;
* a CPU tensor never launches the kernel, ``impl="cuda"`` on one raises;
* the sparse tick calls the segment sum the number of times a tick that
  ``chip_smoke.py`` counts on the card: 22 on a 3-level grid, 15 on a
  2-tier one, 27 under the CC zoo;
* ``warp_fold``'s plan and schedule (the kernel ``seg_sum`` launches): on
  the pod64 / pod256 / pod1024 and incast48_sparse plans and on
  adversarial indices (every entry in one bin, empty bins, no entries,
  one bin, bins of 33 and 1,000 entries across chunk edges) the long bins
  are exactly those of at least ``SEG_LONG_MIN`` entries (the kernel's
  ``kLongMin``), in a block of any width the launch picks every bin has
  one agent (a warp or a thread), and the entries it loads, chunk by
  chunk, cover its segment once in ascending order; a numpy emulation of
  the kernel's fold order (warp chunks of 32 four at a time, thread groups of
  4, both padded with -0.0) gives the plain version's bits.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fabric import fused
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric.cc import CcConfig
from repro_torch.fabric.vector import FabricRun, FabricSweepParams

torch.set_num_threads(1)

DTYPES = {"float32": np.float32, "float64": np.float64}


def _inputs(seed, rows, n, size, dtype):
    """Values whose sums depend on the order (1e8 + 1 - 1e8 is 0 or 1),
    bins with many, one and no entries."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, size, n)
    idx[: n // 4] = 0                  # one crowded bin
    vals = rng.choice([1e8, 1.0, -1e8, 0.3, -2.5, 0.0, -0.0],
                      size=(rows, n)).astype(dtype)
    return vals, idx


def _add_at(vals, idx, size):
    acc = np.zeros((vals.shape[0], size), vals.dtype)
    np.add.at(acc, (np.arange(vals.shape[0])[:, None], idx[None, :]), vals)
    return acc


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n,size", [(1, 1, 1), (3, 50, 7),
                                         (4, 1158, 693), (2, 300, 1000)])
def test_plain_version_equals_add_at_bitwise(dtype, rows, n, size):
    vals, idx = _inputs(1, rows, n, size, DTYPES[dtype])
    want = _add_at(vals, idx, size)
    got = fused.seg_sum_ref(torch.from_numpy(vals), torch.from_numpy(idx),
                            size).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(_bits(got), _bits(want))


def test_plain_version_keeps_leading_axes():
    vals, idx = _inputs(2, 6, 40, 9, np.float64)
    v3 = torch.from_numpy(vals.reshape(2, 3, 40))
    got = fused.seg_sum_ref(v3, torch.from_numpy(idx), 9)
    assert got.shape == (2, 3, 9)
    assert np.array_equal(got.reshape(6, 9).numpy(), _add_at(vals, idx, 9))


def test_plan_is_a_stable_sort_with_csr_offsets():
    idx = np.array([3, 0, 3, 1, 0, 3, 5, 1])
    plan = fused.seg_plan(idx, 7)
    assert plan.perm.dtype == torch.int32
    assert plan.offsets.dtype == torch.int32
    assert plan.idx.dtype == torch.int64 and plan.size == 7
    assert plan.perm.tolist() == [1, 4, 3, 7, 0, 2, 5, 6]
    assert plan.offsets.tolist() == [0, 2, 4, 4, 7, 7, 8, 8]
    with pytest.raises(ValueError, match="out of range"):
        fused.seg_plan(np.array([0, 7]), 7)
    with pytest.raises(ValueError, match="out of range"):
        fused.seg_plan(np.array([-1]), 7)
    empty = fused.seg_plan(np.zeros(0, np.int64), 3)
    assert empty.offsets.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_order_equals_plain_version(dtype):
    """The kernel's loop, emulated in numpy: for each bin, from 0.0, add
    the entries ``perm[offsets[b]:offsets[b+1]]`` one at a time."""
    dt = DTYPES[dtype]
    vals, idx = _inputs(3, 4, 600, 37, dt)
    plan = fused.seg_plan(idx, 37)
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    emu = np.zeros((4, 37), dt)
    for b in range(37):
        for j in range(off[b], off[b + 1]):
            emu[:, b] = (emu[:, b] + vals[:, perm[j]]).astype(dt)
    got = fused.seg_sum(torch.from_numpy(vals), plan).numpy()
    assert np.array_equal(_bits(emu), _bits(got))


def test_cpu_tensors_never_launch_and_cuda_impl_raises():
    vals, idx = _inputs(4, 2, 10, 4, np.float32)
    plan = fused.seg_plan(idx, 4)
    fused.reset_launches()
    a = fused.seg_sum(torch.from_numpy(vals), plan)
    b = fused.seg_sum(torch.from_numpy(vals), plan, impl="ref")
    assert torch.equal(a, b)
    assert fused.LAUNCHES["seg_sum"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        fused.seg_sum(torch.from_numpy(vals), plan, impl="cuda")


def _pods(M=TSC, **kw):
    return M.pod_incast_grid(pods=2, leaves_per_pod=2, hosts_per_leaf=2,
                             burst_mb=0.2, sim_time_s=0.0001, **kw)[0]


def _cc_pods():
    scens = _pods()
    for s, algo in zip(scens, ("dcqcn", "timely", "hpcc", "timely")):
        s.fabric.cc = CcConfig(algo=algo)
    return scens


def _two_tier():
    return [TSC.incast(4, mode=m, burst_mb=0.2, sim_time_s=0.0001)
            for m in ("jet", "ddio")]


@pytest.mark.parametrize("make,want", [(_pods, 22), (_two_tier, 15),
                                       (_cc_pods, 27)],
                         ids=["3-level", "2-tier", "3-level-cc"])
def test_segment_sums_a_tick(monkeypatch, make, want):
    """Injection 2, a drain per occupied slot, 2 per enqueue, the uplink
    tx of slots 1-2, PFC 2; under the CC zoo one more a drain (the INT
    tx, shared with the uplink tx) and one for the queue telemetry."""
    fsp = FabricSweepParams.from_scenarios(make(), sparse=True)
    calls = []
    real = fused.seg_sum

    def counting(vals, plan, impl="auto"):
        calls.append(plan.size)
        return real(vals, plan, impl=impl)
    monkeypatch.setattr(fused, "seg_sum", counting)
    run = FabricRun(fsp, device="cpu", graph=False)
    run.step(run.state, 0)
    assert len(calls) == want


# --------------------------------------------------------------------------- #
# warp_fold: the plan, the schedule and the fold order
# --------------------------------------------------------------------------- #


def _incast48():
    """``chip_smoke.py``'s main grid (8 senders, receiver mode x PFC x 12
    bursts), packed sparse: incast48_sparse."""
    bursts = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
    return TSC.fabric_grid(
        lambda mode, pfc, burst_mb: TSC.incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=0.00001),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=bursts)[0]


def _pod_cell(pods, leaves):
    return TSC.pod_incast_grid(pods=pods, leaves_per_pod=leaves,
                               hosts_per_leaf=16, burst_mb=0.2,
                               sim_time_s=0.00001)[0]


@functools.lru_cache(maxsize=None)
def _path_plans(cell):
    """Every segment-sum plan of a cell's sparse tick, by name."""
    from repro_torch.fabric.vector import _seg_plans
    scens = (_incast48() if cell == "incast48_sparse" else
             _pod_cell(*{"pod64": (2, 2), "pod256": (4, 4),
                         "pod1024": (4, 16)}[cell]))
    fsp = FabricSweepParams.from_scenarios(scens, sparse=True)
    out = {}
    for key, v in _seg_plans(fsp, "cpu").items():
        for i, pl in enumerate(v if isinstance(v, list) else [v]):
            out[f"{key}[{i}]" if isinstance(v, list) else key] = pl
    return out


def _straddling():
    """A bin of 33 entries and one of 1,000 whose segments start off the
    32-entry chunk edges, between short bins, the entries shuffled."""
    rng = np.random.default_rng(7)
    idx = np.concatenate([np.full(5, 0), np.full(33, 1), np.full(1000, 2),
                          rng.integers(3, 40, 300), np.full(31, 41),
                          np.full(32, 42)])
    return rng.permutation(idx), 45


ADVERSARIAL = {
    "one bin holds all": (np.zeros(1000, np.int64), 5),
    "empty bins": (np.array([1, 4, 4, 1, 7, 4] * 3), 9),
    "no entries": (np.zeros(0, np.int64), 3),
    "one bin": (np.zeros(50, np.int64), 1),
    "33 and 1000 across chunk edges": _straddling(),
}
CELLS = ("pod64", "pod256", "pod1024", "incast48_sparse")


def _plans(case):
    if case in CELLS:
        return list(_path_plans(case).values())
    idx, size = ADVERSARIAL[case]
    return [fused.seg_plan(idx, size)]


def _agents(plan, threads):
    """warp_fold's split of a row's bins (``sum_row``) in a block of
    ``threads``: the agents of each bin, ("warp", w) for a long bin,
    ("thread", t) for a short one (on the warps that hold no long bin,
    when there are fewer long bins than warps)."""
    counts = np.diff(plan.offsets.numpy())
    long_bins = plan.long_bins.numpy()
    warps = threads // 32
    who = [[] for _ in range(plan.size)]
    for k, b in enumerate(long_bins):
        who[b].append(("warp", k % warps))
    busy = len(long_bins) if len(long_bins) < warps else 0
    step = threads - 32 * busy
    for b in range(plan.size):
        if counts[b] < fused.SEG_LONG_MIN:
            who[b].append(("thread", 32 * busy + b % step))
    return who


def _groups(plan, b):
    """The entry positions j (into ``perm``) the agent of bin b loads, a
    step at a time, in fold order; -1 where a step runs past the bin (an
    add of -0.0).  A warp: four chunks of 32 a step, folding the chunks
    that start inside the bin; a thread: four entries a step."""
    off = plan.offsets.numpy()
    lo, hi = int(off[b]), int(off[b + 1])
    width = 128 if hi - lo >= fused.SEG_LONG_MIN else 4
    out = []
    for g in range(lo, hi, width):
        chunks = min(4, (hi - g + 31) // 32) if width == 128 else 1
        j = g + np.arange(32 * chunks if width == 128 else 4)
        out.append(np.where(j < hi, j, -1))
    return out


def _emulate(vals, plan):
    """warp_fold's fold order in numpy float32: each bin from 0.0, adding
    the values of its steps' entries in order, -0.0 past its end."""
    perm = plan.perm.numpy()
    out = np.zeros((vals.shape[0], plan.size), np.float32)
    pad = np.float32(-0.0)
    for b in range(plan.size):
        acc = np.zeros(vals.shape[0], np.float32)
        for step in _groups(plan, b):
            for j in step:
                acc = acc + (vals[:, perm[j]] if j >= 0 else pad)
        out[:, b] = acc
    return out


@pytest.mark.parametrize("case", CELLS + tuple(ADVERSARIAL))
def test_long_bins_are_those_of_at_least_long_min(case):
    for plan in _plans(case):
        counts = np.diff(plan.offsets.numpy())
        assert plan.long_bins.dtype == torch.int32
        assert plan.long_bins.tolist() == \
            np.flatnonzero(counts >= fused.SEG_LONG_MIN).tolist()


@pytest.mark.parametrize("threads", (128, 256, 1024))
@pytest.mark.parametrize("case", CELLS + tuple(ADVERSARIAL))
def test_schedule_covers_every_entry_once_in_entry_order(case, threads):
    """In a block of ``threads`` (the launch picks 128 to 1,024: a warp a
    long bin and a thread a short one, 1,024 in a persistent block):
    every bin has exactly one agent; the entries its steps load are its
    segment, once each, ascending; over all bins every entry of the row
    is loaded once."""
    for plan in _plans(case):
        off, perm = plan.offsets.numpy(), plan.perm.numpy()
        seen = np.zeros(plan.n, np.int64)
        for b, agents in enumerate(_agents(plan, threads)):
            assert len(agents) == 1, (b, agents)
            kind, k = agents[0]
            assert k < (threads // 32 if kind == "warp" else threads)
            j = np.concatenate([s[s >= 0] for s in _groups(plan, b)]
                               or [np.zeros(0, np.int64)])
            assert j.tolist() == list(range(off[b], off[b + 1]))
            seen[perm[j]] += 1
        assert (seen == 1).all()


def test_the_path_plans_have_their_incast_bins_long():
    """The incast receiver's (TC, port) bin is the longest: as long as
    the fan-in, 768 of pod1024's 769 slot-5 entries, and a warp folds
    it."""
    longest = {cell: max(int(np.diff(pl.offsets.numpy()).max())
                         for pl in _path_plans(cell).values())
               for cell in ("pod64", "pod256", "pod1024")}
    assert longest == {"pod64": 35, "pod256": 195, "pod1024": 771}
    slot5 = _path_plans("pod1024")["qp_k[5]"]
    counts = np.diff(slot5.offsets.numpy())
    assert slot5.n == 769 and counts.max() == 768
    assert slot5.long_bins.tolist() == [int(counts.argmax())]


@pytest.mark.parametrize("case", CELLS + tuple(ADVERSARIAL))
def test_fold_order_emulation_equals_plain_version_bitwise(case):
    """Values whose sums depend on the order (1e8 + 1 - 1e8), signed
    zeros: the kernel's order, padding included, gives the plain
    version's bits on every plan."""
    rng = np.random.default_rng(11)
    for plan in _plans(case)[:8]:
        vals = rng.choice(np.array([1e8, 1.0, -1e8, 0.3, -2.5, 0.0, -0.0],
                                   np.float32), size=(3, plan.n))
        want = fused.seg_sum_ref(torch.from_numpy(vals), plan.idx,
                                 plan.size).numpy()
        assert np.array_equal(_bits(_emulate(vals, plan)), _bits(want))


def test_adding_minus_zero_keeps_every_bit():
    """The padding's premise: x + (-0.0) == x bit for bit in float32 for
    signed zeros, subnormals, the extremes and infinities."""
    f = np.finfo(np.float32)
    x = np.array([0.0, -0.0, 1.0, -1.0, f.tiny, -f.tiny, f.smallest_subnormal,
                  -f.smallest_subnormal, f.max, -f.max, np.inf, -np.inf,
                  1e8, 0.3], np.float32)
    assert np.array_equal(_bits(x + np.float32(-0.0)), _bits(x))


def test_long_min_is_the_kernels():
    """The plan's long bins are the ones the kernel leaves to a warp: its
    short-bin loop skips a bin of ``kLongMin`` entries or more, so the
    two numbers must be one."""
    src = (Path(fused.__file__).resolve().parents[1] / "csrc"
           / "seg_sum.cu").read_text()
    got = re.findall(r"constexpr int kLongMin = (\d+);", src)
    assert got == [str(fused.SEG_LONG_MIN)]


def test_plan_is_checked_once_when_made():
    plan = fused.seg_plan(np.array([0, 2, 2]), 3)
    assert plan.n == 3 and plan.device == torch.device("cpu")
    with pytest.raises(TypeError):
        fused.SegPlan(idx=plan.idx, perm=plan.perm.long(),
                      offsets=plan.offsets, size=3,
                      long_bins=plan.long_bins)
    with pytest.raises(ValueError):
        fused.SegPlan(idx=plan.idx, perm=plan.perm, offsets=plan.offsets,
                      size=4, long_bins=plan.long_bins)
    with pytest.raises(ValueError, match="variant"):
        fused.seg_sum(torch.zeros(3), plan, _variant="tree")
