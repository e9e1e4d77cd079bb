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
  2-tier one, 27 under the CC zoo.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""
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
