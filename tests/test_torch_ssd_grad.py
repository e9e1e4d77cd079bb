"""The SSD scan's gradient on the CPU.

* The plain backward (``ref.ssd_chunked_bwd_ref``, written out chunk by
  chunk in the passes of ``csrc/ssd_scan_bwd.cu``; ``chip_smoke.py`` and
  the card tests hold the kernel against it) against torch autograd of
  the plain forward (``ref.ssd_chunked_ref``) and against ``jax.vjp`` of
  the reference's plain scan (``repro.kernels.ref.ssd_chunked_ref``), on
  the same numpy-seeded inputs: one chunk, several, G < H, N != P, P not
  a multiple of 8, dh None and non-zero, bfloat16.
* The dispatch on the card, rehearsed here with the CUDA branch forced
  and the kernels replaced by plain stand-ins (forward: the plain scan;
  backward: the plain backward): ``ops.ssd`` goes through ``SSDScan``
  under grad (one ``ssd_scan`` and one ``ssd_scan_bwd`` a call), a tiny
  zamba2 train step through it matches the reference's gradients, and a
  checkpointed Mamba2 layer counts two forwards and one backward.
* The backward's width rule and shared-memory plan.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS, tiny_config as jtiny
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.parallel.sharding import single_device_ctx
from repro_torch import _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.fabric import fused
from repro_torch.kernels import jet_flash_attention as jfa
from repro_torch.kernels import mamba2_ssd as mssd
from repro_torch.kernels import ops, ref
from repro_torch.models import api, transformer
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

# of each gradient's largest magnitude: against torch autograd both sides
# are float32 sums in other orders; against jax.vjp also another
# framework's exp and cumsum; bfloat16 rounds every gradient (and
# autograd sums the heads of a group in bfloat16)
AUTOGRAD_TOL = 1e-5
JAX_TOL = 1e-4
BF16_TOL = 2e-2

CASES = {  # B, T, H, P, G, N, chunk, dtype
    "one chunk": (1, 32, 2, 8, 1, 8, 32, "float32"),
    "chunks": (2, 96, 3, 8, 1, 8, 32, "float32"),
    "G<H": (1, 64, 4, 8, 2, 16, 16, "float32"),
    "N!=P": (1, 64, 2, 16, 1, 4, 32, "float32"),
    "P=20": (1, 48, 2, 20, 1, 12, 16, "float32"),
    "bf16": (1, 64, 4, 16, 1, 8, 32, "bfloat16"),
}
NAMES = ("dx", "ddt", "da", "db", "dc")


def _inputs(case, seed, with_dh):
    """numpy float32 x, dt, a, b, c, dy, dh (None without) as the Mamba2
    block makes them: dt = softplus around 0.05, a from -1 to -8."""
    B, T, H, P, G, N, _, _ = CASES[case]
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, b, c, dy = draw(B, T, H, P), draw(B, T, G, N), draw(B, T, G, N), \
        draw(B, T, H, P)
    z = draw(B, T, H) * 0.5 + math.log(math.expm1(0.05))
    dt = np.log1p(np.exp(z)).astype(np.float32)
    a = -np.linspace(1.0, 8.0, H).astype(np.float32)
    dh = draw(B, H, N, P) if with_dh else None
    return x, dt, a, b, c, dy, dh


def _torch(case, arrays):
    dtype = getattr(torch, CASES[case][7])
    x, dt, a, b, c, dy, dh = arrays
    out = [torch.from_numpy(v).to(dtype) for v in (x, dt)]
    out.append(torch.from_numpy(a))
    out += [torch.from_numpy(v).to(dtype) for v in (b, c, dy)]
    out.append(None if dh is None else torch.from_numpy(dh))
    return out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd(case, with_dh):
    chunk, dtype = CASES[case][6], CASES[case][7]
    x, dt, a, b, c, dy, dh = _torch(case, _inputs(case, 1, with_dh))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, h = ref.ssd_chunked_ref(*leaves, chunk=chunk)
    outs, ups = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
    want = torch.autograd.grad(outs, leaves, ups)
    got = ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, dh, chunk=chunk)
    tol = BF16_TOL if dtype == "bfloat16" else AUTOGRAD_TOL
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(_f32(g), _f32(w)) <= tol, (name, _rel(_f32(g), _f32(w)))
    assert got[2].dtype == torch.float32


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case, with_dh):
    """The reference has no backward kernel: JAX differentiates its plain
    chunked scan, whose vjp is the gradient the card's kernel replaces."""
    chunk, dtype = CASES[case][6], CASES[case][7]
    arrays = _inputs(case, 2, with_dh)
    x, dt, a, b, c, dy, dh = arrays
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    prim = [jnp.asarray(x, jdt), jnp.asarray(dt, jdt), jnp.asarray(a),
            jnp.asarray(b, jdt), jnp.asarray(c, jdt)]

    def f(*args):
        return jref.ssd_chunked_ref(*args, chunk=chunk)
    (y, h), vjp = jax.vjp(f, *prim)
    jh = jnp.asarray(dh) if with_dh else jnp.zeros_like(h)
    want = vjp((jnp.asarray(dy, jdt), jh))
    got = ref.ssd_chunked_bwd_ref(*_torch(case, arrays), chunk=chunk)
    tol = BF16_TOL if dtype == "bfloat16" else JAX_TOL
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        assert _rel(_f32(g), w) <= tol, (name, _rel(_f32(g), w))


def test_plain_forward_gradient_survives_decay_overflow():
    """At a chunk of 256 with a = -8 and dt ~ 0.05, exp(cum_l - cum_m)
    above the diagonal overflows float32.  The plain forward selects it
    away before the exp, so its autograd gradient stays finite and equal
    to the plain backward's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 256, 2, 8))
                         .astype(np.float32))
    dt = torch.full((1, 256, 2), 0.06)
    a = torch.tensor([-8.0, -1.0])
    b = torch.from_numpy(rng.standard_normal((1, 256, 1, 4))
                         .astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((1, 256, 1, 4))
                         .astype(np.float32))
    dy = torch.ones_like(x)
    assert 255 * 0.06 * 8.0 > math.log(torch.finfo(torch.float32).max)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, _ = ref.ssd_chunked_ref(*leaves, chunk=256)
    want = torch.autograd.grad(y, leaves, dy)
    got = ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, None, chunk=256)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(w).all()), name
        assert _rel(_f32(g), _f32(w)) <= AUTOGRAD_TOL, name


def test_cpu_dispatch_keeps_autograd():
    """On the CPU ``ops.ssd`` runs the plain version, which autograd
    differentiates: no ``SSDScan``, and its gradient is the plain
    backward's."""
    x, dt, a, b, c, dy, _ = _torch("G<H", _inputs("G<H", 4, False))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, _ = ops.ssd(*leaves, chunk=16)
    assert type(y.grad_fn).__name__ != "SSDScanBackward"
    got = torch.autograd.grad(y, leaves, dy)
    want = ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, None, chunk=16)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(_f32(g), _f32(w)) <= AUTOGRAD_TOL, name


# --------------------------------------------------------------------------- #
# the card's dispatch, rehearsed on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_branch(monkeypatch):
    """Every wrapper takes its CUDA branch on CPU tensors; the SSD scan's
    and flash attention's kernels are replaced by plain stand-ins that
    record their calls (the backward's states argument: None, as after a
    forward that kept none), every other kernel by one that fails if it
    is reached."""
    calls = []
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(fused, "resolve_impl", lambda impl, dev: "cuda")

    def ssd_fwd(x, dt, a, b, c, chunk, _variant=None):
        calls.append("ssd_fwd")
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)

    def ssd_fwd_states(x, dt, a, b, c, chunk, _variant=None):
        calls.append("ssd_fwd_states")
        return (*ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk), None)

    def ssd_bwd(x, dt, a, b, c, dy, dh, chunk, states=None):
        calls.append("ssd_bwd")
        assert states is None
        return ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, dh, chunk=chunk)

    def flash_fwd(q, k, v, causal=True, window=None, with_lse=False):
        calls.append("flash_fwd")
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return (out, torch.zeros(q.shape[:3])) if with_lse else out

    def flash_bwd(q, k, v, out, dout, lse, causal=True, window=None):
        calls.append("flash_bwd")
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal, window)

    def unreachable(*a, **kw):
        raise AssertionError("a kernel without a backward was launched")
    monkeypatch.setattr(mssd, "ssd_scan", ssd_fwd)
    monkeypatch.setattr(mssd, "ssd_scan_states", ssd_fwd_states)
    monkeypatch.setattr(mssd, "ssd_scan_bwd", ssd_bwd)
    monkeypatch.setattr(ops, "_ssd_cuda", ssd_fwd)
    monkeypatch.setattr(jfa, "flash_attention", flash_fwd)
    monkeypatch.setattr(jfa, "flash_attention_bwd", flash_bwd)
    monkeypatch.setattr(ops, "_flash_cuda", flash_fwd)
    for name in ("_decode_cuda", "_matmul_cuda"):
        monkeypatch.setattr(ops, name, unreachable)
    for name in ("_seg_sum_cuda", "_grants_cuda", "_admit_cuda"):
        monkeypatch.setattr(fused, name, unreachable)
    ops.reset_launches()
    yield calls
    ops.reset_launches()


@pytest.mark.parametrize("with_dh", [False, True])
def test_ssd_under_grad_runs_the_autograd_function(cuda_branch, with_dh):
    x, dt, a, b, c, dy, dh = _torch("chunks", _inputs("chunks", 5, with_dh))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, h = ops.ssd(*leaves, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    outs, ups = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
    got = torch.autograd.grad(outs, leaves, ups)
    want = ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, dh, chunk=32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cuda_branch == ["ssd_fwd_states", "ssd_bwd"]
    counts = ops.LAUNCHES.read()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    # without grad: the serve path's kernel, no states kept, no backward
    with torch.no_grad():
        ops.ssd(*leaves, chunk=32)
    assert cuda_branch[-1] == "ssd_fwd"
    assert ops.LAUNCHES.read()["ssd_scan"] == 2
    assert ops.LAUNCHES.read()["ssd_scan_bwd"] == 1


def test_ssd_gradient_of_the_state_alone(cuda_branch):
    """Only h used: y's gradient is None, the backward takes it as 0."""
    x, dt, a, b, c, _, dh = _torch("G<H", _inputs("G<H", 6, True))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    _, h = ops.ssd(*leaves, chunk=16)
    got = torch.autograd.grad(h, leaves, dh)
    want = ref.ssd_chunked_bwd_ref(x, dt, a, b, c, torch.zeros_like(x), dh,
                                   chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_backward_refuses_widths_before_the_forward(cuda_branch):
    x = torch.zeros((1, 16, 2, 8), requires_grad=True)
    bc = torch.zeros((1, 16, 1, 136))
    with pytest.raises(ValueError, match="does not take N=136"):
        ops.ssd(x, torch.zeros((1, 16, 2)), torch.zeros(2), bc, bc, chunk=16)
    assert cuda_branch == []
    assert ops.LAUNCHES.read()["ssd_scan"] == 0


def _zamba2_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 32))
            .astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (2, 32))
            .astype(np.int32)}


def test_tiny_zamba2_step_matches_the_reference(cuda_branch):
    """tiny zamba2 (6 Mamba2 layers and one with the shared attention
    block) through ``SSDScan`` and ``FlashAttention`` with the plain
    stand-ins: loss within 1e-5 and every gradient leaf within 1e-4 of
    ``jax.value_and_grad`` of the reference's loss."""
    arch = "zamba2-1.2b"
    jcfg, cfg = jtiny(ARCHS[arch]), tiny_config(get_arch(arch))
    jp = japi.init_params(jcfg, jax.random.key(0))
    batch = _zamba2_batch(cfg, 7)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: japi.loss_fn(p, jcfg, single_device_ctx(remat="none"),
                                   bb, jnp.float32),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    live = [p.requires_grad_(True) for p in _tree.leaves(params)]
    loss, _ = transformer.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()}, remat="full")
    grads = torch.autograd.grad(loss, live)
    counts = ops.LAUNCHES.read()
    assert counts["ssd_scan_bwd"] == 7 and counts["flash_attention_bwd"] == 1
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, _), g, (_, w) in zip(_tree.flatten(params), grads, jflat):
        assert tuple(g.shape) == w.shape, path
        assert _rel(g.numpy(), w) <= 1e-4, (path, _rel(g.numpy(), w))


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
def test_training_launch_counts(cuda_branch, remat, per_layer):
    """A train step launches the SSD scan once a Mamba2 layer, once more
    on each replay of a checkpointed unit, and its backward once a layer.
    The remainder layers after the last whole pattern unit are not
    checkpointed (as in the reference), so they run once: zamba2-1.2b's
    38 = 6 x 6 + 2 count 2 x 36 + 2 = 74 forwards a step and 38
    backwards."""
    cfg = dataclasses.replace(tiny_config(get_arch("zamba2-1.2b")),
                              num_layers=8)
    pattern, n_units, rem = transformer.segments(cfg)
    ssd_kinds = ("mamba", "mamba_attn")
    in_units = n_units * sum(k in ssd_kinds for k in pattern)
    in_rem = sum(k in ssd_kinds for k in rem)
    assert (in_units, in_rem) == (6, 2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _zamba2_batch(cfg, 8)
             .items()}
    live = [p.requires_grad_(True) for p in _tree.leaves(params)]
    loss, _ = transformer.loss_fn(params, cfg, batch, remat=remat)
    torch.autograd.grad(loss, live)
    counts = ops.LAUNCHES.read()
    assert counts["ssd_scan"] == per_layer * in_units + in_rem
    assert counts["ssd_scan_bwd"] == in_units + in_rem
    assert counts["flash_attention"] == per_layer * n_units
    assert counts["flash_attention_bwd"] == n_units
    full = transformer.segments(get_arch("zamba2-1.2b"))
    assert (full[1] * len(full[0]), len(full[2])) == (36, 2)


# --------------------------------------------------------------------------- #
# the backward's widths and shared memory
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p", [(1, 1), (4, 20), (64, 64), (12, 128),
                                 (128, 8), (128, 128)])
def test_backward_takes_every_width_up_to_128(dtype, n, p, forced):
    # the design bwd_variant picks, and the first design forced (it takes
    # every width)
    mssd.check_bwd(dtype, n, p)
    name = "bwd_simt" if forced else mssd.bwd_variant(dtype, n, p)
    assert mssd.bwd_smem_bytes(name, n, p) <= 232_448  # the H100's block


@pytest.mark.parametrize("dtype,n,p,err", [
    (torch.float16, 64, 64, TypeError), (torch.float32, 136, 64, ValueError),
    (torch.float32, 64, 256, ValueError), (torch.bfloat16, 0, 8, ValueError)])
def test_backward_refuses_other_widths(dtype, n, p, err):
    with pytest.raises(err):
        mssd.check_bwd(dtype, n, p)


@pytest.mark.parametrize("name,path,widest,narrow", [
    # bwd_simt: the key pass is the largest: b and x key tiles of 64 rows
    # of 65 words, four weights a key, then c and dy row tiles, their cum
    # and two 64 x 65 score tiles: (2 * 4160 + 256 + 2 * 4160 + 64 + 8320)
    # * 4; at 128 x 128 tiles of 129-word rows
    ("bwd_simt", 101_120, 166_656, (20, 12)),
    # bwd_mma_3xtf32: the key and row passes, equal: own b and x (c and dy)
    # tiles of 64 rows of 68 words, four (two) weights a row, two ring
    # stages of the other pair with one (two) weights: (8704 + 256 + 2 *
    # (8704 + 64)) * 4; at 128 x 128 rows of 132 words
    ("bwd_mma_3xtf32", 105_984, 204_288, (24, 16))])
def test_backward_smem_plan_at_the_path_and_the_widest_widths(name, path,
                                                              widest, narrow):
    assert mssd.bwd_smem_bytes(name, 64, 64) == path
    assert mssd.bwd_smem_bytes(name, 128, 128) == widest
    # widths pad to the 64 tile: no plan depends on them below it
    assert mssd.bwd_smem_bytes(name, *narrow) == path
