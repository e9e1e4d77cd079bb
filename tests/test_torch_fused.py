"""The port's priority water-fills against the reference's tiers.

The plain PyTorch versions must equal ``repro.fabric.fused``'s numpy ref
tier and its Pallas kernel under the interpreter bit for bit in float32
— the standard the reference holds its own kernel to
(``tests/test_fused.py``).  The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.fabric import fused as ref_fused
from repro_torch.fabric import fused
from repro_torch.kernels import ops

torch.set_num_threads(1)

# the engine's main-path shape, a column count that is not a multiple of
# 128, a single column, and a wide one
SHAPES = [(48, 3, 14), (5, 3, 130), (1, 3, 1), (3, 3, 257)]


def _inputs(seed, shape):
    """Seeded water-fill inputs with zero demands, all-False ``can``
    rows (a whole grid point and single classes) and zero budgets."""
    rng = np.random.default_rng(seed)
    g, q, n = shape
    demand = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    demand[rng.random(shape) < 0.2] = 0.0
    can = rng.random(shape) < 0.7
    can[0] = False
    can[-1, 1] = False
    budget = rng.uniform(0.0, 6.0, (g, n)).astype(np.float32)
    budget[:, rng.random(n) < 0.1] = 0.0
    crumb = np.full((g, n), 1e-3, np.float32)
    return demand, can, budget, crumb


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_grants_plain_matches_reference_tiers_bitwise(shape, seed):
    demand, can, budget, crumb = _inputs(seed, shape)
    canf = can.astype(np.float32)
    want = ref_fused.priority_grants(np, demand, canf, budget, crumb,
                                     np.float32(1.0), np.float32(0.0))
    interp = ref_fused.priority_grants(
        jnp, jnp.asarray(demand), jnp.asarray(canf), jnp.asarray(budget),
        jnp.asarray(crumb), jnp.float32(1.0), jnp.float32(0.0),
        impl="interpret")
    assert np.array_equal(_bits(want), _bits(interp))
    for c in (_t(can), _t(canf)):          # bool (engine) and {0,1} float
        got = fused.priority_grants(_t(demand), c, _t(budget), _t(crumb))
        assert got.dtype == torch.float32
        assert np.array_equal(_bits(got.numpy()), _bits(want))
    # an all-False grid point grants nothing
    assert not got[0].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_admit_plain_matches_reference_tiers_bitwise(shape, seed):
    demand, _, space, _ = _inputs(seed, shape)
    want = ref_fused.priority_admit(np, demand, space)
    interp = ref_fused.priority_admit(jnp, jnp.asarray(demand),
                                      jnp.asarray(space), impl="interpret")
    assert np.array_equal(_bits(want), _bits(interp))
    got = fused.priority_admit(_t(demand), _t(space))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_admit_matches_reference_at_admission_shape():
    """[G, Q, R] = [48, 3, 2]: the receiver admission of the incast grid."""
    demand, _, space, _ = _inputs(3, (48, 3, 2))
    want = ref_fused.priority_admit(np, demand, space)
    got = fused.priority_admit(_t(demand), _t(space))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_float64_plain_versions_match_numpy_reference():
    demand, can, budget, crumb = _inputs(4, (6, 3, 14))
    d64, b64, c64 = (a.astype(np.float64) for a in (demand, budget, crumb))
    want = ref_fused.priority_grants(np, d64, can, b64, c64,
                                     np.float64(1.0), np.float64(0.0))
    got = fused.priority_grants(_t(d64), _t(can), _t(b64), _t(c64))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fused.priority_admit(_t(d64), _t(b64)).numpy(),
                          ref_fused.priority_admit(np, d64, b64))


def test_cpu_tensors_never_launch_and_cuda_impl_raises():
    demand, can, budget, crumb = _inputs(5, (2, 3, 4))
    fused.reset_launches()
    fused.priority_grants(_t(demand), _t(can), _t(budget), _t(crumb))
    fused.priority_admit(_t(demand), _t(budget))
    assert fused.LAUNCHES == {"priority_grants": 0, "priority_admit": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fused.priority_grants(_t(demand), _t(can), _t(budget), _t(crumb),
                              impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fused.priority_admit(_t(demand), _t(budget), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        fused.priority_admit(_t(demand), _t(budget), impl="pallas")
    assert torch.equal(
        fused.priority_admit(_t(demand), _t(budget), impl="ref"),
        fused.priority_admit_ref(_t(demand), _t(budget)))
    assert fused.LAUNCHES == {"priority_grants": 0, "priority_admit": 0}


def test_resolve_impl():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert fused.resolve_impl("auto", cpu) == "ref"
    assert fused.resolve_impl("auto", gpu) == "cuda"
    assert fused.resolve_impl("cuda", gpu) == "cuda"
    assert fused.resolve_impl("ref", gpu) == "ref"
    assert fused.resolve_impl is ops.resolve_impl     # one dispatch policy
    with pytest.raises(ValueError):
        fused.resolve_impl("cuda", cpu)
    with pytest.raises(ValueError):
        fused.resolve_impl("pallas", gpu)
