"""The port's CUDA kernels on the card (``cuda`` marker).

Needs an NVIDIA card and ``nvcc``; every test skips without one.  The
file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.fabric import fused
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric.vector import run_fabric_sweep

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


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_bitwise(card, shape):
    demand, can, budget, crumb = _inputs(6, shape, card)
    fused.reset_launches()
    got = fused.priority_grants(demand, can, budget, crumb)
    acc = fused.priority_admit(demand, budget)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"priority_grants": 1, "priority_admit": 1}
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
    fused.reset_launches()
    got = run_fabric_sweep(scens)
    assert fused.LAUNCHES == {"priority_grants": 800, "priority_admit": 200}
    want = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    for k in ("flow_goodput_gbps", "flow_completion_us"):
        a, b = got[k], want[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=5e-4, atol=0.0), k
