"""Gradients through the port's kernels on the CPU.

* Flash attention's plain backward (``ref.flash_attention_bwd_ref``,
  which ``chip_smoke.py`` holds the card's ``flash_attention_bwd`` kernel
  against) against ``jax.grad`` of the reference's plain tier
  (``repro.kernels.ops.flash_attention(impl="ref")``): causal, a window
  shorter than T, non-causal T < S, GQA 4:1 and MHA.
* The dispatch on the card, rehearsed here with the CUDA branch forced
  and the kernels replaced by their plain versions: flash attention goes
  through ``FlashAttention`` under grad (one ``flash_attention_bwd`` a
  call, the forward counted again on each activation-checkpoint replay)
  and through the plain kernel without; every kernel with no backward
  raises under grad before it launches (``_device.require_no_grad``;
  the SSD scan has its backward since: ``tests/test_torch_ssd_grad.py``).
* The backward kernel's head-dim rule, variants and tile / shared-memory
  plan (its arithmetic: ``tests/test_torch_flash_bwd.py``).
* The activation-checkpoint policies: ``remat`` "none", "full" and
  "dots" give the same gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch import _device, _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.fabric import fused
from repro_torch.kernels import jet_flash_attention as jfa
from repro_torch.kernels import ops, ref
from repro_torch.models import api, transformer

torch.set_num_threads(1)

# both sides are float32 plain attention whose sums run in other orders:
# within 1e-5 of each gradient's largest magnitude
GRAD_TOL = 1e-5

CASES = {  # b, hq, hkv, t, s, d, causal, window
    "causal": (2, 2, 2, 48, 48, 32, True, None),
    "window<T": (1, 4, 2, 64, 64, 16, True, 24),
    "non-causal T<S": (2, 2, 1, 24, 56, 32, False, None),
    "gqa 4:1": (1, 8, 2, 40, 40, 24, True, None),
    "mha": (1, 3, 3, 33, 33, 8, True, None),
}


def _inputs(case, seed):
    b, hq, hkv, t, s, d, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, t, d))]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad(case):
    *_, causal, window = CASES[case]
    q, k, v, do = _inputs(case, 1)

    def f(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   impl="ref")
        return jnp.sum(out * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = ref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)),
                                      causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= GRAD_TOL


def test_cpu_dispatch_keeps_autograd():
    """On the CPU ``ops.flash_attention`` runs the plain version, which
    autograd differentiates: its gradient is the plain backward's."""
    q, k, v, do = map(torch.from_numpy, _inputs("gqa 4:1", 2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# the card's dispatch, rehearsed on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_branch(monkeypatch):
    """Every wrapper takes its CUDA branch on CPU tensors; flash
    attention's kernels are replaced by plain stand-ins that record their
    calls, every other kernel by one that fails if it is reached."""
    calls = []
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(fused, "resolve_impl", lambda impl, dev: "cuda")

    def fwd(q, k, v, causal=True, window=None, with_lse=False):
        calls.append("fwd_lse" if with_lse else "fwd")
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not with_lse:
            return out
        lse = torch.zeros(q.shape[:3])      # unused by the stand-in below
        return out, lse

    def bwd(q, k, v, out, dout, lse, causal=True, window=None):
        calls.append("bwd")
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal, window)

    def unreachable(*a, **kw):
        raise AssertionError("a kernel without a backward was launched")
    monkeypatch.setattr(jfa, "flash_attention", fwd)
    monkeypatch.setattr(jfa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(ops, "_flash_cuda", fwd)
    for name in ("_ssd_cuda", "_decode_cuda", "_matmul_cuda"):
        monkeypatch.setattr(ops, name, unreachable)
    for name in ("_seg_sum_cuda", "_grants_cuda", "_admit_cuda"):
        monkeypatch.setattr(fused, name, unreachable)
    ops.reset_launches()
    yield calls
    ops.reset_launches()


def test_flash_under_grad_runs_the_autograd_function(cuda_branch):
    q, k, v, do = map(torch.from_numpy, _inputs("window<T", 3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=24)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=True, window=24)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cuda_branch == ["fwd_lse", "bwd"]
    assert ops.LAUNCHES.read()["flash_attention"] == 1
    assert ops.LAUNCHES.read()["flash_attention_bwd"] == 1
    # without grad: the serve path's kernel, no lse, no backward
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=True, window=24)
    assert cuda_branch[-1] == "fwd"
    assert ops.LAUNCHES.read()["flash_attention"] == 2


def test_flash_backward_refuses_unaligned_head_dims(cuda_branch):
    q = torch.zeros((1, 2, 8, 20), requires_grad=True)
    k = torch.zeros((1, 2, 8, 20))
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(q, k, k, causal=True)
    assert cuda_branch == []


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2),
                                                 ("dots", 2)])
def test_training_launch_counts(cuda_branch, remat, fwd_per_layer):
    """A train step's loss and gradient launch flash attention once a
    layer in the forward, once more on each replay of a checkpointed
    unit, and its backward once a layer: the counts ``chip_smoke.py``
    expects of danube (24 layers: 48 and 24 under ``remat="full"``)."""
    cfg = dataclasses.replace(tiny_config(get_arch("h2o-danube-1.8b")),
                              num_layers=3)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, gen, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (2, 16),
                                      generator=gen)}
    live = [p.requires_grad_(True) for p in _tree.leaves(params)]
    loss, _ = transformer.loss_fn(params, cfg, batch, remat=remat)
    torch.autograd.grad(loss, live)
    counts = ops.LAUNCHES.read()
    assert counts["flash_attention"] == fwd_per_layer * cfg.num_layers
    assert counts["flash_attention_bwd"] == cfg.num_layers


def _guarded_calls():
    q, pages = torch.zeros((1, 2, 8)), torch.zeros((2, 4, 2, 8))
    table = torch.zeros((1, 2), dtype=torch.int32)
    lengths = torch.ones((1,), dtype=torch.int32)
    m, plan_vals = torch.zeros((4, 4)), torch.zeros((2, 3))
    plan = fused.seg_plan(np.array([0, 1, 1]), 2)
    demand = torch.zeros((2, 3, 4))
    return {
        "decode_attention_paged": (lambda g: ops.decode_attention(
            q.requires_grad_(g), pages, pages, table, lengths)),
        "staged_matmul": (lambda g: ops.staged_matmul(m.requires_grad_(g),
                                                      m)),
        "seg_sum": (lambda g: fused.seg_sum(plan_vals.requires_grad_(g),
                                            plan)),
        "priority_grants": (lambda g: fused.priority_grants(
            demand.requires_grad_(g), demand > 0, torch.zeros((2, 4)),
            torch.zeros((2, 4)))),
        "priority_admit": (lambda g: fused.priority_admit(
            demand.requires_grad_(g), torch.zeros((2, 4)))),
    }


@pytest.mark.parametrize("name", sorted(_guarded_calls()))
def test_kernels_without_backward_raise_under_grad(cuda_branch, name):
    call = _guarded_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has "
                                           f"no backward"):
        call(True)
    # without grad the guard lets the launch through (here: the
    # stand-in that fails, so the guard ran first above)
    with torch.no_grad(), pytest.raises(AssertionError, match="launched"):
        call(True)
    with pytest.raises(AssertionError, match="launched"):
        call(False)


def test_require_no_grad():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: .* no backward"):
        _device.require_no_grad("ssd_scan", torch.zeros(2), t)
    _device.require_no_grad("ssd_scan", torch.zeros(2), None)
    with torch.no_grad():
        _device.require_no_grad("ssd_scan", t)


# --------------------------------------------------------------------------- #
# the backward kernel's head dims and shared memory
# --------------------------------------------------------------------------- #
# the backward's plan by variant and head-dim tile, as Plan in
# csrc/flash_attention_bwd.cu sizes it: (dk/dv query stage, dq key stage,
# dk/dv column split), (dk/dv, dq shared memory in bytes)
BWD_PLAN = {
    ("bwd_mma_3xtf32", 32): ((64, 64, 1), (56_320, 55_296)),
    ("bwd_mma_3xtf32", 64): ((64, 64, 1), (105_472, 104_448)),
    ("bwd_mma_3xtf32", 80): ((32, 32, 1), (86_528, 86_016)),
    ("bwd_mma_3xtf32", 128): ((16, 16, 1), (101_632, 101_376)),
    ("bwd_mma_3xtf32", 256): ((16, 16, 2), (199_936, 199_680)),
    ("bwd_mma_bf16", 32): ((64, 64, 1), (31_744, 30_720)),
    ("bwd_mma_bf16", 64): ((64, 64, 1), (56_320, 55_296)),
    ("bwd_mma_bf16", 80): ((64, 64, 1), (68_608, 67_584)),
    ("bwd_mma_bf16", 128): ((32, 64, 1), (70_144, 104_448)),
    ("bwd_mma_bf16", 256): ((16, 32, 2), (101_632, 135_168)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 64, 80, 128, 256])
def test_backward_takes_every_mma_head_dim(dtype, d):
    """Every head dim that is a multiple of 8 runs the tensor-core design
    of its type, on the plan of its head-dim tile: two blocks share an SM
    (shared memory ≤ half the SM's 228 KB less 1 KB a block) up to
    D = 128, every
    block fits the H100's 227 KB, and the score accumulators beside dk
    and dv (or dq) stay within 192 floats a thread, so that ptxas has
    room for the fragments and addresses without spilling."""
    name = jfa.bwd_variant(dtype, d)
    assert name == ("bwd_mma_bf16" if dtype == torch.bfloat16
                    else "bwd_mma_3xtf32")
    dt = jfa.d_tile(d)
    tiles, smem = BWD_PLAN[(name, dt)]
    assert jfa.bwd_tiles(name, d) == tiles
    assert jfa.bwd_smem_bytes(name, d) == smem
    bq, bk, split = tiles
    assert max(smem) <= 232_448                    # the H100's block limit
    if dt <= 128:
        assert max(smem) <= 232_448 // 2 - 1024
    assert dt // split + bq <= 192 and dt // 2 + bk <= 192
    # the first design, reachable only by asking for it: its plan is kept
    t = 64 if d <= 128 else 32
    assert jfa.bwd_tiles("bwd_simt", d) == (t, t, 1)
    assert jfa.bwd_smem_bytes("bwd_simt", d)[0] <= 232_448


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float32, 20, ValueError), (torch.float32, 100, ValueError),
    (torch.bfloat16, 264, ValueError), (torch.float16, 64, TypeError)])
def test_backward_refuses_other_head_dims(dtype, d, err):
    with pytest.raises(err):
        jfa.bwd_variant(dtype, d)


# --------------------------------------------------------------------------- #
# activation checkpointing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                                  "zamba2-1.2b", "llama-3.2-vision-11b"])
def test_remat_policies_give_equal_gradients(arch):
    """A checkpointed unit replays the same operations on the same
    inputs, and "dots" keeps outputs that the replay would recompute
    bit for bit: on the CPU the three gradients are equal exactly."""
    cfg = tiny_config(get_arch(arch))
    gen = torch.Generator().manual_seed(1)
    params = api.init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, api.token_shape(cfg, 2, 16)).astype(np.int32)),
        "targets": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    out = {}
    for remat in ("none", "full", "dots"):
        live = [p.detach().requires_grad_(True)
                for p in _tree.leaves(params)]
        loss, _ = transformer.loss_fn(_tree.unflatten(params, live), cfg,
                                      batch, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, live))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("remat,match", [("layer_out", None),
                                         ("offload", "unknown remat")])
def test_remat_refuses_mesh_knobs_and_unknown_policies(remat, match):
    """``"layer_out"`` (the reference's save-only-the-marked-outputs
    policy) runs with no mesh, as in the reference, and its forward
    equals ``"none"``'s bit for bit; an unknown policy raises."""
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    if match is None:
        with torch.enable_grad():
            got, _ = transformer.forward(params, cfg, tokens, remat=remat)
        want, _ = transformer.forward(params, cfg, tokens)
        assert torch.equal(got, want)
        return
    with pytest.raises(ValueError, match=match):
        transformer.forward(params, cfg, tokens, remat=remat)
