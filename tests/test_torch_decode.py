"""The paged decode kernel's choices, launch plan and numerics on the CPU.

On the card ``repro_torch.kernels.ops.decode_attention`` runs
``csrc/decode_attention.cu``: the position axis split across blocks
(split-KV), each warp of a block streaming its own steps of positions with
its own online softmax, the warps merged at the end of a split and the
splits merged through their raw float32 ``(m, l, acc)``.  The kernels run
only on the card (``tests/test_torch_cuda.py``); here the same arithmetic
is emulated in torch, with the split ranges of the kernel's own plan
(``jet_decode_attention.split_plan``) and each product rounded as the
kernel rounds it, and held against the reference's Pallas kernel run by
the interpreter within ``tests/test_kernels.py``'s 2e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch import _build
from repro_torch.kernels import jet_decode_attention as jd
from repro_torch.kernels import ops

torch.set_num_threads(1)

TOL = 2e-4                  # tests/test_kernels.py, o and lse
F32, BF16 = torch.float32, torch.bfloat16
SMS = 132                   # an H100 SXM; the wrapper reads the card's


# --------------------------------------------------------------------------- #
# the kernel choice and the launch plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("q_dtype,kv_dtype,name", [
    (F32, F32, "simt_f32"), (BF16, F32, "simt_f32"),
    (BF16, BF16, "mma_bf16"), (F32, BF16, "mma_bf16x2")])
@pytest.mark.parametrize("d", [8, 64, 80, 128, 256])
def test_variant_follows_the_types(q_dtype, kv_dtype, name, d):
    assert jd.variant(q_dtype, kv_dtype, d, 12) == name


@pytest.mark.parametrize("q_dtype,kv_dtype,d,g,err,match", [
    (torch.float16, F32, 64, 1, TypeError, "float32 or bfloat16"),
    (F32, F32, 6, 1, ValueError, "head dim"),         # not 16-byte rows
    (F32, BF16, 12, 1, ValueError, "head dim"),       # 24-byte bf16 rows
    (F32, F32, 264, 1, ValueError, "head dim"),       # past 256
    (BF16, BF16, 264, 1, ValueError, "head dim"),
    (BF16, BF16, 64, 33, ValueError, "group"),
])
def test_variant_refuses_what_no_kernel_takes(q_dtype, kv_dtype, d, g, err,
                                              match):
    with pytest.raises(err, match=match):
        jd.variant(q_dtype, kv_dtype, d, g)


@pytest.mark.parametrize("q_dtype,kv_dtype", [(F32, F32), (BF16, F32),
                                              (BF16, BF16), (F32, BF16)])
@pytest.mark.parametrize("d", [8, 64, 80, 128, 136, 256])
@pytest.mark.parametrize("g", [1, 4, 12, 32])
def test_plan_fits_a_block_at_every_width(q_dtype, kv_dtype, d, g):
    # the widest table a split can meet: one split over 32,768 positions
    for page, maxp, splits in ((16, 2048, 1), (16, 2048, None),
                               (1, 32768, None)):
        p = jd.split_plan(q_dtype, kv_dtype, 2, 2 * g, 2, d, page, maxp,
                          SMS, splits)
        smem = max(v[0] for v in p["kernels"].values())
        assert smem <= jd.SMEM_PER_BLOCK, (page, maxp, splits, smem)
        assert p["splits"] * p["chunk"] >= maxp * page
        assert p["chunk"] % jd.TILE == 0


def test_plan_at_the_rows_of_the_chip_smoke_test():
    # starcoder2-15b: 32 (sequence, KV head) pairs and 128 tiles a table;
    # S aims at 4 blocks an SM
    p = jd.split_plan(BF16, BF16, 8, 48, 4, 128, 16, 512, SMS)
    assert (p["variant"], p["splits"], p["chunk"]) == ("mma_bf16", 16, 512)
    assert p["kernels"]["decode_split_mma_kernel"][1] == 512
    assert p["kernels"]["decode_merge_kernel"] == (64, 8 * 48)
    # llama4-scout: 256 pairs already, so few splits of many positions
    p = jd.split_plan(BF16, BF16, 32, 40, 8, 128, 16, 2048, SMS)
    assert (p["splits"], p["chunk"]) == (3, 10944)
    # zamba2's shared attention on float32 pages
    p = jd.split_plan(F32, F32, 6, 32, 32, 64, 16, 64, SMS)
    assert (p["variant"], p["splits"], p["head_tiles"]) == ("simt_f32", 3,
                                                            1)
    # a group of 32: two head tiles of 16 on the tensor cores
    p = jd.split_plan(F32, BF16, 2, 64, 2, 256, 16, 64, SMS)
    assert (p["variant"], p["head_tiles"]) == ("mma_bf16x2", 2)


def test_plan_needs_no_merge_when_the_pairs_fill_the_card():
    p = jd.split_plan(BF16, BF16, 64, 32, 32, 128, 16, 64, SMS)
    assert p["splits"] == 1 and list(p["kernels"]) == [
        "decode_split_mma_kernel"]


def test_plan_keeps_forced_splits_past_the_table():
    # 4 tiles a table, 40 splits: splits 4..39 own no position
    p = jd.split_plan(F32, F32, 4, 8, 2, 64, 8, 32, SMS, splits=40)
    assert (p["splits"], p["chunk"]) == (40, 64)
    assert p["kernels"]["decode_split_simt_kernel"][1] == 4 * 2 * 40


def test_plan_narrows_the_split_where_its_table_would_not_fit():
    # page 1: a split's table entries are its positions
    p = jd.split_plan(BF16, BF16, 1, 16, 16, 256, 1, 32768, SMS)
    assert p["kernels"]["decode_split_mma_kernel"][0] <= jd.SMEM_PER_BLOCK
    assert p["chunk"] < 32768 // 16
    with pytest.raises(ValueError, match="shared"):
        jd.split_plan(BF16, BF16, 1, 16, 16, 256, 1, 32768, SMS, splits=1)


def test_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 64))
    kp = torch.zeros((2, 16, 2, 64))
    table = torch.zeros((1, 2), dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        jd.decode_attention_paged(q, kp, kp, table, lens)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.decode_attention(q, kp, kp, table, lens, impl="cuda")


# --------------------------------------------------------------------------- #
# the build cache
# --------------------------------------------------------------------------- #
def test_build_key_hashes_the_headers_a_source_includes(tmp_path):
    keys = []
    for i, body in enumerate(("#define X 1\n", "#define X 2\n")):
        d = tmp_path / str(i)
        (d / "sub").mkdir(parents=True)
        (d / "k.cu").write_text('#include "h.cuh"\n#include <cuda.h>\n'
                                'int f() { return X; }\n')
        (d / "h.cuh").write_text('#include "sub/g.cuh"\n')
        (d / "sub" / "g.cuh").write_text(body)
        keys.append(_build.source_key(d / "k.cu"))
    assert keys[0] != keys[1]
    # the same texts in another directory give the same key
    d = tmp_path / "again"
    (d / "sub").mkdir(parents=True)
    for rel in ("k.cu", "h.cuh", "sub/g.cuh"):
        (d / rel).write_bytes((tmp_path / "0" / rel).read_bytes())
    assert _build.source_key(d / "k.cu") == keys[0]


def test_decode_source_includes_the_shared_header():
    src = (_build.CSRC / "decode_attention.cu").read_bytes()
    assert _build._INCLUDE.findall(src) == [b"mma_sync.cuh"]
    assert (_build.CSRC / "mma_sync.cuh").is_file()


# --------------------------------------------------------------------------- #
# the kernel's arithmetic, emulated
# --------------------------------------------------------------------------- #
def _bf(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    hi = _bf(x)
    return hi, _bf(x - hi)


def _emulate(q, kp, vp, table, lengths, plan, rounding):
    """The kernel's arithmetic: split s of (b, KV head) owns positions
    [s * chunk, min((s + 1) * chunk, length)); warp w of its block takes
    steps w, w + 4, .. of 16 positions (8 on float32 pages) with its own
    online softmax; the warps merge at the end of the split, and the
    splits through their raw (m, l, acc).  ``rounding`` is what the
    products see: ``f32`` (q scaled first, as the CUDA-core kernel does),
    ``x2`` (q and P each as two bf16 halves, scores scaled after the
    products) or ``x1`` (q and P rounded to bf16 once)."""
    b_n, hq, d = q.shape
    n_pool, page, hkv, _ = kp.shape
    maxp = table.shape[1]
    g = hq // hkv
    rows = 8 if rounding == "f32" else 16
    scale = d ** -0.5
    safe = table.clamp(0, n_pool - 1).long()
    o = torch.zeros((b_n, hq, d))
    lse = torch.zeros((b_n, hq))
    neg = torch.tensor(-1e30)

    def product(a, b):                     # [G, D] . [R, D]^T in float32
        if rounding == "f32":
            return a @ b.T
        hi, lo = _hi_lo(a)
        return hi @ b.T + (lo @ b.T if rounding == "x2" else 0)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        f = [torch.exp(p[0] - m) for p in parts]
        return (m, sum(p[1] * fi for p, fi in zip(parts, f)),
                sum(p[2] * fi[:, None] for p, fi in zip(parts, f)))
    for b in range(b_n):
        n = max(0, min(int(lengths[b]), maxp * page))
        for kvh in range(hkv):
            qg = q[b, kvh * g:(kvh + 1) * g].float()
            qs = qg * scale if rounding == "f32" else qg
            splits = []
            for s in range(plan["splits"]):
                p0 = s * plan["chunk"]
                pend = min(p0 + plan["chunk"], n)
                steps = range(p0, pend, rows)
                warps = []
                for w in range(4):
                    m, l, acc = torch.full((g,), -1e30), torch.zeros(g), \
                        torch.zeros((g, d))
                    for start in steps[w::4]:
                        pos = torch.arange(start, start + rows)
                        live = pos < pend
                        at = pos.clamp(max=maxp * page - 1)
                        pg = safe[b, at // page]
                        kr = kp[pg, at % page, kvh].float() * live[:, None]
                        vr = vp[pg, at % page, kvh].float() * live[:, None]
                        sc = product(qs, kr)
                        if rounding != "f32":
                            sc = sc * scale
                        sc = torch.where(live[None, :], sc, neg)
                        mn = torch.maximum(m, sc.amax(1))
                        corr = torch.exp(m - mn)
                        p = torch.exp(sc - mn[:, None])
                        l = l * corr + p.sum(1)
                        if rounding == "f32":
                            pv = p @ vr
                        else:
                            hi, lo = _hi_lo(p)
                            pv = hi @ vr + (lo @ vr if rounding == "x2"
                                            else 0)
                        acc = acc * corr[:, None] + pv
                        m = mn
                    warps.append((m, l, acc))
                splits.append(merge(warps))
            m, l, acc = merge(splits)
            den = torch.clamp(l, min=1e-30)
            o[b, kvh * g:(kvh + 1) * g] = acc / den[:, None]
            lse[b, kvh * g:(kvh + 1) * g] = m + torch.log(den)
    return o, lse


def _inputs(seed, b, hq, hkv, d, page, lengths, hole=None, q_scale=1.0):
    """Pages, a shuffled page table with -1 past each length (and ``hole``
    = (sequence, entry) set to -1 inside it), lengths, q."""
    rng = np.random.default_rng(seed)
    need = [-(-n // page) for n in lengths]
    maxp, pool = max(max(need), 1), sum(need) + 2
    kp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    table = np.full((b, maxp), -1, np.int32)
    perm = rng.permutation(pool)
    at = 0
    for i, k in enumerate(need):
        table[i, :k] = perm[at:at + k]
        at += k
    if hole is not None:
        table[hole] = -1
    q = (rng.standard_normal((b, hq, d)) * q_scale).astype(np.float32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _reference_kernel(q, kp, vp, table, lengths, kv_bf16=False):
    """The reference's Pallas kernel under the interpreter, float32 q."""
    kj, vj = jnp.asarray(kp), jnp.asarray(vp)
    if kv_bf16:
        kj, vj = kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16)
    o, lse = jops.decode_attention(jnp.asarray(q), kj, vj,
                                   jnp.asarray(table), jnp.asarray(lengths),
                                   impl="interpret")
    return torch.from_numpy(np.array(o, np.float32)), \
        torch.from_numpy(np.array(lse, np.float32))


def _err(got, want):
    """max of |got - want| / (1 + |want|): the abs + rel tier's reading."""
    return float(((got - want).abs() / (1 + want.abs())).max())


# (b, hq, hkv, d, page, lengths, hole, splits): gemma-7b's head dim 256 at
# the plan's own split count, more splits than the table has tiles (empty
# splits) with a length-0 row, a page shorter than a 16-position step with
# a hole where the second split starts, a page longer than a split's 64
# positions (splits start mid-page) and a group of 32
EMULATED = [
    (2, 4, 2, 256, 16, [70, 33], None, None),
    (3, 4, 1, 64, 8, [0, 40, 57], None, 9),
    (2, 8, 2, 64, 8, [100, 30], (0, 8), 2),
    (2, 4, 1, 32, 100, [250, 170], None, 4),
    (1, 32, 1, 32, 16, [90], None, 2),
]


@pytest.mark.parametrize("rounding,kv_bf16", [("f32", False),
                                              ("x2", True)])
@pytest.mark.parametrize("b,hq,hkv,d,page,lengths,hole,splits", EMULATED)
def test_split_design_matches_the_reference_kernel(b, hq, hkv, d, page,
                                                   lengths, hole, splits,
                                                   rounding, kv_bf16):
    q, kp, vp, table, lens = _inputs(b * 7 + d + page, b, hq, hkv, d, page,
                                     lengths, hole)
    if kv_bf16:
        kp, vp = (_bf(torch.from_numpy(x)).numpy() for x in (kp, vp))
    kv = BF16 if kv_bf16 else F32
    plan = jd.split_plan(F32, kv, b, hq, hkv, d, page, table.shape[1], SMS,
                         splits)
    assert plan["variant"] == ("mma_bf16x2" if kv_bf16 else "simt_f32")
    if splits:
        assert plan["splits"] == splits
    o, lse = _emulate(torch.from_numpy(q), torch.from_numpy(kp),
                      torch.from_numpy(vp), torch.from_numpy(table),
                      torch.from_numpy(lens), plan, rounding)
    o_ref, lse_ref = _reference_kernel(q, kp, vp, table, lens, kv_bf16)
    assert _err(o, o_ref) <= TOL
    assert _err(lse, lse_ref) <= TOL
    zero = torch.from_numpy(lens) == 0
    assert bool((o[zero] == 0).all()) and bool((lse[zero] == -1e30).all())


def test_two_bf16_halves_hold_what_one_rounding_misses():
    # float32 q over bfloat16 pages at a sharp softmax (q scaled up 8x):
    # the kernel's mma_bf16x2 splits q and P into two bf16 halves each
    q, kp, vp, table, lens = _inputs(5, 2, 8, 2, 128, 16, [300, 77],
                                     q_scale=8.0)
    kp, vp = (_bf(torch.from_numpy(x)).numpy() for x in (kp, vp))
    plan = jd.split_plan(F32, BF16, 2, 8, 2, 128, 16, table.shape[1], SMS)
    o_ref, lse_ref = _reference_kernel(q, kp, vp, table, lens, True)
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, lens)]
    o2, lse2 = _emulate(*args, plan, "x2")
    o1, lse1 = _emulate(*args, plan, "x1")
    assert _err(o2, o_ref) <= TOL and _err(lse2, lse_ref) <= TOL
    assert max(_err(o1, o_ref), _err(lse1, lse_ref)) > TOL
    assert _err(o1, o_ref) > 10 * _err(o2, o_ref)


@pytest.mark.parametrize("hq,hkv,page,lengths", [(4, 2, 16, [70, 33]),
                                                 (16, 16, 8, [0, 41])])
def test_plain_version_at_head_dim_256_matches_the_reference_kernel(
        hq, hkv, page, lengths):
    q, kp, vp, table, lens = _inputs(hq + page, 2, hq, hkv, 256, page,
                                     lengths, (1, 0) if lengths[0] else None)
    o, lse = ops.decode_attention(*(torch.from_numpy(x) for x in
                                    (q, kp, vp, table, lens)))
    o_ref, lse_ref = _reference_kernel(q, kp, vp, table, lens)
    live = torch.from_numpy(lens) > 0     # length 0: the plain version
    assert _err(o[live], o_ref[live]) <= TOL     # gives the mean of v
    assert _err(lse, lse_ref) <= TOL
