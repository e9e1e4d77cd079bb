"""The port's dry-run (``repro_torch.launch.{dryrun,hlo_analysis,
inspect_hlo}``) and ``models.api.abstract_params`` against the reference.

The reference's dry-run compiles each cell against placeholder devices;
its own end-to-end test fails under jax 0.9.0, and its placeholder
devices have no torch counterpart to compare with.  So the port is held
to what the reference can give here, and to what the card measured:

* the ring model: ``hlo_analysis.analyze`` on records of real ``c10d``
  calls against the reference's ``hlo_analysis.analyze`` on the HLO
  lines of ``tests/test_quant_and_accounting.py`` (1e-9);
* dot FLOPs of one unsharded train step of six tiny archs (batch 2 x
  64, float32, the plain versions) against the reference's
  single-device compile: danube equal, the others within 0.5 %; scout
  after the reference's dense MoE work (every expert on every token,
  ``moe_dense_ref``) beyond the port's capacity dispatch is taken off;
* a placeholder world against 8 real gloo ranks: the same collectives,
  in order, with the same shapes, types and group sizes;
* the collective counts NCCL recorded on the card (``chip_smoke.py``'s
  ``mesh_step_collectives``, ``tests/test_torch_cuda.py``'s
  ``SCOUT_EP_COLLECTIVES``) and the one-card kernel launches a step
  (``chip_smoke.train_launches``), at full width on meta tensors;
* the production meshes, the CLI, the memory tracker and the meta
  path's refusals.

A test that starts a placeholder group does so through
``dryrun.placeholder_group``, which destroys it on exit, and asserts that
no group is left up: the xdist workers run several files in turn.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS, tiny_config as jtiny
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_analysis as jhlo
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.parallel.sharding import single_device_ctx
from repro.train import steps as jsteps
from repro_torch import _build, _tree
from repro_torch._device import meta_launch
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, tiny_config
from repro_torch.kernels import jet_flash_attention as jfa
from repro_torch.kernels import mamba2_ssd as mssd
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_analysis, inspect_hlo
from repro_torch.launch.mesh import PRODUCTION, ctx_for_mesh, make_mesh
from repro_torch.models import api, decoding, transformer
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Mesh
from repro_torch.train import steps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
Op = hlo_analysis.Op
RING_TOL = 1e-9
FLOP_TOL = 5e-3              # relative, every arch but danube (equal)
CLI_TIMEOUT_S = 300          # the reference's CLI test's limit
RANKS_TIMEOUT_S = 300
TINY = ShapeConfig("tiny", "train", 64, 2)
# NCCL's host record names of the c10d ops (the card's counts)
NCCL = {"allgather_": "nccl:all_gather",
        "_reduce_scatter_base_": "nccl:_reduce_scatter_base",
        "allreduce_": "nccl:all_reduce", "alltoall_base_": "nccl:all_to_all"}


@pytest.fixture
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _entry(body: str) -> str:
    return "ENTRY %main (p0: f32[8]) -> f32[8] {\n  " + body + "\n}\n"


def _mesh_ops(world: int, fn) -> list:
    """The ops of ``fn(group)`` on meta tensors, traced as rank 0 of a
    placeholder world of ``world`` ranks (``group``: the whole world)."""
    with dryrun.placeholder_group(world):
        return hlo_analysis.trace(fn, dist.group.WORLD).ops


def _meta(*shape):
    return torch.empty(shape, device="meta")


# --------------------------------------------------------------------------- #
# the ring model
# --------------------------------------------------------------------------- #
RING_CASES = {
    # the reference's HLO line, and the c10d call that makes its record
    "all-gather": ("%ag = f32[64,4]{1,0} all-gather(%x), "
                   "replica_groups={{0,1,2,3}}, dimensions={0}",
                   lambda g: dist.all_gather([_meta(16, 4) for _ in range(4)],
                                             _meta(16, 4), group=g)),
    "all-reduce": ("%ar = f32[64,4]{1,0} all-reduce(%x), "
                   "replica_groups={{0,1,2,3}}, to_apply=%add",
                   lambda g: dist.all_reduce(_meta(64, 4), group=g)),
    "reduce-scatter": ("%rs = f32[16,4]{1,0} reduce-scatter(%x), "
                       "replica_groups={{0,1,2,3}}, dimensions={0}, "
                       "to_apply=%add",
                       lambda g: dist.reduce_scatter_tensor(
                           _meta(16, 4), _meta(64, 4), group=g)),
    "all-to-all": ("%aa = f32[64,4]{1,0} all-to-all(%x), "
                   "replica_groups={{0,1,2,3}}, dimensions={0}",
                   lambda g: dist.all_to_all_single(_meta(64, 4),
                                                    _meta(64, 4), group=g)),
}


@pytest.mark.parametrize("kind", sorted(RING_CASES))
def test_ring_model_matches_the_reference(kind, no_group_left):
    line, call = RING_CASES[kind]
    ops_ = _mesh_ops(4, call)
    [rec] = [op for op in ops_ if op.coll]
    assert rec.coll == kind and rec.group == 4
    got = hlo_analysis.analyze(ops_)
    want = jhlo.analyze(_entry(line))
    assert abs(got["coll"][kind] - want["coll"][kind]) <= RING_TOL
    assert got["coll_counts"][kind] == want["coll_counts"][kind] == 1
    assert abs(got["coll_total"] - want["coll_total"]) <= RING_TOL


def test_ring_model_permute():
    """A send's record against the reference's collective-permute (no
    replica groups there: n = 2, the whole tensor)."""
    line = ("%cp = f32[64,4]{1,0} collective-permute(%x), "
            "source_target_pairs={{0,1},{1,0}}")
    rec = Op("c10d.send.default", outputs=(((64, 4), "float32"),), group=2)
    got = hlo_analysis.analyze([rec])["coll"]["collective-permute"]
    want = jhlo.analyze(_entry(line))["coll"]["collective-permute"]
    assert abs(got - want) <= RING_TOL and got == 64 * 4 * 4


def test_unrolled_trace_equals_the_reference_trip_count(no_group_left):
    """Twelve all-reduces of f32[8] over two ranks, traced, against the
    reference's 12-trip while body (``tests/test_quant_and_accounting.py``
    ``test_trip_count_weighting``)."""
    hlo = """
%cond (c: (s32[], f32[8])) -> pred[] {
  %c = (s32[], f32[8]) parameter(0)
  %i = s32[] get-tuple-element(%c), index=0
  %k = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %k), direction=LT
}
%body (b: (s32[], f32[8])) -> (s32[], f32[8]) {
  %b = (s32[], f32[8]) parameter(0)
  %v = f32[8]{0} get-tuple-element(%b), index=1
  %ar = f32[8]{0} all-reduce(%v), replica_groups={{0,1}}, to_apply=%add
  %i2 = s32[] get-tuple-element(%b), index=0
  ROOT %t = (s32[], f32[8]) tuple(%i2, %ar)
}
ENTRY %main (p: (s32[], f32[8])) -> (s32[], f32[8]) {
  %p = (s32[], f32[8]) parameter(0)
  ROOT %w = (s32[], f32[8]) while(%p), condition=%cond, body=%body
}
"""
    def twelve(g):
        x = _meta(8)
        for _ in range(12):
            dist.all_reduce(x, group=g)
    got = hlo_analysis.analyze(_mesh_ops(2, twelve))
    want = jhlo.analyze(hlo)
    assert want["trip_counts"] == [12]
    assert abs(got["coll"]["all-reduce"] - want["coll"]["all-reduce"]) \
        <= RING_TOL
    assert got["coll_counts"]["all-reduce"] == 12
    assert "trip_counts" not in got


# --------------------------------------------------------------------------- #
# dot FLOPs against the reference's single-device compile
# --------------------------------------------------------------------------- #
def _ref_dot_flops(name: str) -> float:
    cfg, opt = jtiny(JARCHS[name]), jadamw.OptConfig()
    state = jax.eval_shape(lambda: jsteps.init_state(cfg, opt,
                                                     jax.random.key(0)))
    batch = japi.input_specs(cfg, JShape("tiny", "train", TINY.seq_len,
                                         TINY.global_batch), jnp.float32)
    step = jsteps.make_train_step(cfg, single_device_ctx(), opt,
                                  jnp.float32)
    hlo = jax.jit(step).lower(state, batch).compile().as_text()
    return jhlo.analyze(hlo)["dot_flops"]


def _port_trace(cfg, impl="ref", shape=TINY):
    opt = adamw.OptConfig()
    fn = steps.make_train_step(cfg, opt, torch.float32, impl=impl)
    return hlo_analysis.trace(fn, steps.abstract_state(cfg, opt),
                              api.input_specs(cfg, shape, torch.float32))


def _dense_moe_extra(cfg, shape=TINY, passes: int = 2) -> float:
    """The reference's dense MoE work beyond the port's capacity dispatch
    in one step, from the shapes: each MoE layer's expert FFN (2 or 3
    products of 2·D·F a token and expert) runs on all N tokens instead of
    C a slab, twice a pass (a train step's passes: the forward and the
    replay, each product with its two in the backward), and its one-hot
    combine (2·N·E·D) once a pass (its backward into the experts' outputs
    is an outer product, no dot).  A prefill is one pass with no
    backward: ``passes=1`` counts its FFN once."""
    n = shape.global_batch * shape.seq_len
    e = cfg.num_experts
    c = max(1, int(cfg.capacity_factor * n / e))
    mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    ffn = (4 if passes == 2 else 1) * e * (n - c) * 2 * cfg.d_model \
        * cfg.d_ff * mats
    combine = passes * 2 * n * e * cfg.d_model
    return layers * (ffn + combine)


# an arch whose reference step fails to compile under jax 0.9.0 would be
# named here; all six compile
FLOP_ARCHS = ("h2o-danube-1.8b", "zamba2-1.2b", "llama4-scout-17b-a16e",
              "xlstm-125m", "llama-3.2-vision-11b", "musicgen-large")


@pytest.mark.parametrize("name", FLOP_ARCHS)
def test_dot_flops_match_the_reference_compile(name):
    cfg = tiny_config(get_arch(name))
    got = hlo_analysis.analyze(_port_trace(cfg).ops)["dot_flops"]
    ref = _ref_dot_flops(name)
    want = ref - (_dense_moe_extra(cfg) if cfg.num_experts else 0.0)
    ratio = got / want
    msg = f"{name}: port {got:.0f}, reference {ref:.0f} ({want:.0f} " \
          f"compared), ratio {ratio:.6f}"
    if name == "h2o-danube-1.8b":
        assert got == want, msg
    else:
        assert abs(ratio - 1.0) <= FLOP_TOL, msg


TINY_PREFILL = ShapeConfig("tiny", "prefill", 64, 2)


def _ref_prefill_dot_flops(name: str) -> float:
    cfg = jtiny(JARCHS[name])
    params = jax.eval_shape(lambda: japi.init_params(cfg, jax.random.key(0)))
    batch = japi.input_specs(cfg, JShape("tiny", "prefill",
                                         TINY_PREFILL.seq_len,
                                         TINY_PREFILL.global_batch),
                             jnp.float32)

    def fn(p, b):
        return japi.prefill(p, cfg, single_device_ctx(), b["tokens"],
                            b.get("patches"), max_len=TINY_PREFILL.seq_len,
                            compute_dtype=jnp.float32)
    hlo = jax.jit(fn).lower(params, batch).compile().as_text()
    return jhlo.analyze(hlo)["dot_flops"]


def _port_prefill_dot_flops(cfg) -> float:
    @torch.no_grad()
    def fn(p, b):
        return api.prefill(p, cfg, b["tokens"], b.get("patches"),
                           max_len=TINY_PREFILL.seq_len, impl="ref")
    tr = hlo_analysis.trace(fn, api.abstract_params(cfg), api.input_specs(
        cfg, TINY_PREFILL, torch.float32))
    return hlo_analysis.analyze(tr.ops)["dot_flops"]


@pytest.mark.parametrize("name", FLOP_ARCHS)
def test_prefill_dot_flops_match_the_reference_compile(name):
    """One unsharded tiny prefill (batch 2 x 64, float32, the plain
    versions) against the reference's single-device compile of its
    ``prefill``, at the train cells' tiers; scout after the reference's
    dense MoE work in one forward is taken off."""
    cfg = tiny_config(get_arch(name))
    got = _port_prefill_dot_flops(cfg)
    ref = _ref_prefill_dot_flops(name)
    want = ref - (_dense_moe_extra(cfg, TINY_PREFILL, passes=1)
                  if cfg.num_experts else 0.0)
    ratio = got / want
    msg = f"{name}: port {got:.0f}, reference {ref:.0f} ({want:.0f} " \
          f"compared), ratio {ratio:.6f}"
    if name == "h2o-danube-1.8b":
        assert got == want, msg
    else:
        assert abs(ratio - 1.0) <= FLOP_TOL, msg


def test_dot_flops_count_as_flop_counter_mode():
    """``dot_flops`` of a step's matmuls equals ``FlopCounterMode``'s
    count of the same ops on CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    opt = adamw.OptConfig()
    state = steps.init_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    batch = api.synthetic_inputs(cfg, TINY, torch.Generator().manual_seed(1),
                                 torch.float32, "cpu")
    fn = steps.make_train_step(cfg, opt, torch.float32)
    tr = hlo_analysis.trace(fn, state, batch)
    with FlopCounterMode(display=False) as fc:
        fn(state, batch)
    counts = fc.get_flop_counts()["Global"]
    want = sum(v for k, v in counts.items()
               if str(k).split(".")[-1] in ("mm", "bmm", "addmm", "baddbmm"))
    assert hlo_analysis.analyze(tr.ops)["dot_flops"] == want > 0


def test_kernel_calls_count_their_operations():
    """On meta tensors a kernel call is one ``meta_launch`` op carrying
    the kernel's operation count, which ``dot_flops`` adds."""
    q = torch.empty((1, 4, 64, 32), device="meta")
    k = torch.empty((1, 2, 64, 32), device="meta")
    tr = hlo_analysis.trace(lambda a, b: ops.flash_attention(a, b, b), q, k)
    [call] = [op for op in tr.ops if op.kernel]
    assert call.kernel == "flash_attention"
    assert call.flops == jfa.flops(1, 4, 64, 64, 32, True, None) \
        == 4.0 * 4 * 32 * jfa.visible_pairs(64, 64, True, None)
    assert hlo_analysis.analyze(tr.ops)["dot_flops"] == call.flops
    assert jfa.visible_pairs(64, 64, True, None) == 64 * 65 // 2


# --------------------------------------------------------------------------- #
# a placeholder world against real ranks
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks") / "collectives.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_dryrun_ranks.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=RANKS_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", ("h2o-danube-1.8b", "zamba2-1.2b",
                                  "llama4-scout-17b-a16e"))
def test_placeholder_world_equals_gloo_ranks(name, gloo_collectives,
                                             no_group_left):
    import torch_dryrun_ranks as ranks
    with dryrun.placeholder_group(ranks.WORLD):
        mesh = make_mesh(ranks.MESH, ("data", "model"), "cpu")
        fn, args = dryrun.build_cell(
            tiny_config(get_arch(name)),
            ShapeConfig("ranks", "train", ranks.SEQ, ranks.BATCH), mesh,
            {}, torch.float32)
        got = ranks.collectives(hlo_analysis.trace(fn, *args).ops)
    want = gloo_collectives[name]
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name}: collective {i}: {g} != {w}"


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("name", ("h2o-danube-1.8b", "zamba2-1.2b"))
def test_placeholder_world_equals_gloo_ranks_serving(name, kind,
                                                     gloo_collectives,
                                                     no_group_left):
    """The serve cells' prefill and decode step: the head exchange and
    the slot split (all-to-all, all-gathers, the combine) collective for
    collective as on 8 gloo ranks."""
    import torch_dryrun_ranks as ranks
    with dryrun.placeholder_group(ranks.WORLD):
        mesh = make_mesh(ranks.MESH, ("data", "model"), "cpu")
        fn, args = dryrun.build_cell(
            tiny_config(get_arch(name)),
            ShapeConfig("ranks", kind, ranks.SEQ, ranks.BATCH), mesh, {},
            torch.float32)
        got = ranks.collectives(hlo_analysis.trace(fn, *args).ops)
    want = gloo_collectives[f"{name}/{kind}"]
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} {kind}: collective {i}: {g} != {w}"
    # the KV heads go to their slot blocks by an all-to-all where the
    # model axis splits them (zamba2's 4), else projected whole (danube's 2)
    split = tiny_config(get_arch(name)).num_kv_heads % ranks.MESH[1] == 0
    assert any(row[0].startswith("c10d.alltoall") for row in got) == \
        (kind == "prefill" and split)


# --------------------------------------------------------------------------- #
# counts the card measured; the one-card kernel launches
# --------------------------------------------------------------------------- #
def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _nccl_counts(ops_) -> dict:
    out = {}
    for op in ops_:
        if op.coll:
            key = NCCL[op.name.split(".")[1]]
            out[key] = out.get(key, 0) + 1
    return out


def test_danube_mesh_step_collectives_as_on_the_card(no_group_left):
    """danube at full width, 6 layers, 2 x 4,096 on a 1 x 1 world: NCCL's
    counts of ``chip_smoke.py``'s ``train_mesh`` (88 / 44 / 34)."""
    cfg = dataclasses.replace(get_arch("h2o-danube-1.8b"), num_layers=6)
    with dryrun.placeholder_group(1):
        fn, args = dryrun.build_cell(
            cfg, ShapeConfig("train_mesh", "train", 4096, 2),
            make_mesh((1, 1), ("data", "model"), "cpu"), {}, torch.float32)
        got = _nccl_counts(hlo_analysis.trace(fn, *args).ops)
    want = _smoke().mesh_step_collectives(cfg)
    assert got == want == {"nccl:all_gather": 88,
                           "nccl:_reduce_scatter_base": 44,
                           "nccl:all_reduce": 34}


def _serve_counts(cfg, params, ctx, specs, b: int, t: int) -> dict:
    """NCCL's names and counts of the collectives of one prefill of ``b``
    x ``t`` tokens and one decode step after it, traced."""
    out = {}
    tokens = torch.zeros((b, t), dtype=torch.int32, device=params[
        "final_norm"].device)
    s_specs = decoding.decode_state_specs(decoding.init_decode_state(
        cfg, b, t, torch.float32, "meta"), ctx)
    with torch.no_grad():
        tr = hlo_analysis.trace(lambda: decoding.prefill(
            params, cfg, tokens, ctx=ctx, specs=specs))
        out["prefill"] = _nccl_counts(tr.ops)
        _, state, lengths = decoding.prefill(params, cfg, tokens, ctx=ctx,
                                             specs=specs)
        tr = hlo_analysis.trace(lambda: decoding.decode_step(
            params, cfg, state, tokens[:, 0], lengths, ctx=ctx, specs=specs,
            state_specs=s_specs))
        out["decode"] = _nccl_counts(tr.ops)
    return out


SERVE_MESH_CFGS = {"danube": ("h2o-danube-1.8b", None),
                   "zamba2_6": ("zamba2-1.2b", 6)}


@pytest.mark.parametrize("size", ("tiny_gloo", "full_placeholder"))
@pytest.mark.parametrize("model", sorted(SERVE_MESH_CFGS))
def test_mesh_serve_collectives_as_designed(model, size, tmp_path,
                                            no_group_left):
    """``chip_smoke.mesh_serve_collectives``, the NCCL records its
    ``serve_mesh`` phase gates, against the collectives a prefill and a
    decode step issue on a one-rank mesh: tiny widths on a real gloo
    group, and at full width on meta tensors in a placeholder world."""
    from repro_torch.launch.mesh import init_group
    arch, layers = SERVE_MESH_CFGS[model]
    cfg = get_arch(arch)
    if size == "tiny_gloo":
        cfg = tiny_config(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    want = _smoke().mesh_serve_collectives(cfg)
    if size == "tiny_gloo":
        init_group("gloo", 0, 1, str(tmp_path / "store"))
        group = contextlib.nullcontext()
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    else:
        group = dryrun.placeholder_group(1)
        params = api.abstract_params(cfg)
    try:
        with group:
            ctx = ctx_for_mesh(make_mesh((1, 1), ("data", "model"), "cpu"))
            specs = steps.param_specs(params, ctx)
            got = _serve_counts(cfg, ctx.shard_tree(params, specs), ctx,
                                specs, 2, 64)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got == want


def test_scout_expert_parallel_collectives_as_on_four_cards(no_group_left):
    """scout at full width, 1 layer, 1 x 1,024 on (1, 4): the counts four
    cards recorded (``SCOUT_EP_COLLECTIVES``)."""
    from test_torch_cuda import SCOUT_EP_COLLECTIVES
    cfg = dataclasses.replace(get_arch("llama4-scout-17b-a16e"),
                              num_layers=1)
    with dryrun.placeholder_group(4):
        fn, args = dryrun.build_cell(
            cfg, ShapeConfig("scout_ep", "train", 1024, 1),
            make_mesh((1, 4), ("data", "model"), "cpu"),
            {"int8_moments": False}, torch.float32)
        got = _nccl_counts(hlo_analysis.trace(fn, *args).ops)
    assert got == SCOUT_EP_COLLECTIVES == {
        "nccl:all_gather": 32, "nccl:_reduce_scatter_base": 12,
        "nccl:all_reduce": 11, "nccl:all_to_all": 6}


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load a kernel's library fails the test."""
    def refuse(name):
        raise AssertionError(f"the meta path asked for the library {name}")
    for mod in (jfa, mssd):
        monkeypatch.setattr(mod, "library", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("name,want", [
    ("h2o-danube-1.8b", {"flash_attention": 48, "flash_attention_bwd": 24}),
    ("zamba2-1.2b", {"ssd_scan": 74, "ssd_scan_bwd": 38,
                     "flash_attention": 12, "flash_attention_bwd": 6})])
def test_one_card_launches_equal_train_launches(name, want, no_build):
    """The one-card step at full width, 2 x 4,096, float32, on meta: each
    kernel counted as ``chip_smoke.train_launches`` says a step, with no
    library built or loaded."""
    cfg = get_arch(name)
    fn, args = dryrun.build_cell(cfg, ShapeConfig("t", "train", 4096, 2),
                                 None, {"remat": "full"}, torch.float32)
    rec = dryrun.trace_step(fn, args)
    launches = rec["kernel_launches"]
    assert launches == _smoke().train_launches(cfg, 1)
    assert {k: v for k, v in launches.items() if v} == want
    kernels = [op for op in hlo_analysis.trace(fn, *args).ops if op.kernel]
    assert len(kernels) == sum(want.values())
    assert rec["temp_size_in_bytes"] > 0
    assert rec["argument_size_in_bytes"] == sum(
        t.numel() * t.element_size() for t in _tree.leaves(args))


# --------------------------------------------------------------------------- #
# production meshes and the CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,shape", [
    ("single", {"data": 16, "model": 16}),
    ("multi", {"pod": 2, "data": 16, "model": 16})])
def test_production_meshes(mesh, shape, tmp_path, no_group_left):
    rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k", mesh,
                          str(tmp_path))
    assert rec["ok"], rec.get("error")
    assert rec["mesh_shape"] == shape
    assert rec["collective_total_per_device"] > 0
    assert rec["flops_per_device"] > 0 and rec["temp_size_in_bytes"] > 0
    assert rec["kernel_launches"]["flash_attention"] == 48
    on_disk = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert on_disk["ok"] and on_disk["mesh_shape"] == shape


@pytest.mark.parametrize("arch,shape,mesh,shape_of_mesh", [
    ("h2o-danube-1.8b", "decode_32k", "single", {"data": 16, "model": 16}),
    ("zamba2-1.2b", "long_500k", "multi",
     {"pod": 2, "data": 16, "model": 16})])
def test_serve_cells_on_the_production_meshes(arch, shape, mesh,
                                              shape_of_mesh, tmp_path,
                                              no_group_left):
    """A decode cell traces on each production mesh: the state's blocks
    among the arguments (the 128 lanes over 16 data ranks; the batch of
    1 replicated over pod and data), the slots over the 16 model ranks,
    no kernel launched (decode runs the plain ring decode) and a
    collective of every kind the design issues."""
    rec = dryrun.run_cell(arch, shape, mesh, str(tmp_path))
    assert rec["ok"], rec.get("error")
    assert rec["mesh_shape"] == shape_of_mesh
    assert rec["flops_per_device"] > 0 and rec["temp_size_in_bytes"] > 0
    assert not any(rec["kernel_launches"].values())
    counts = rec["collective_counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    cfg = get_arch(arch)
    b, s = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    b_loc = b // 16 if b % 16 == 0 else b
    s_loc = min(s, cfg.sliding_window or s) // 16
    kv_block = 2 * b_loc * s_loc * cfg.num_kv_heads * cfg.hd * 2  # bf16
    n_attn = sum(k in ("attn_dense", "mamba_attn")
                 for k in transformer.layer_kinds(cfg))
    assert rec["argument_size_in_bytes"] >= kv_block * n_attn


DECODE_CELLS = [(a, s, m) for a, s, m in dryrun.list_cells(every=True)
                if SHAPES[s].kind == "decode"]


def _ref_state_specs(arch: str, shape: str, multi: bool) -> list:
    """The reference dry-run's decode-state specs (its ``kv_spec``) of a
    production cell, from its own ``build_cell`` on an abstract mesh."""
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.launch import dryrun as jdry
    shp, axes = PRODUCTION[multi]
    specs = jdry.build_cell(arch, shape, AbstractMesh(shp, axes), {})[3]
    return [tuple(p) for p in jax.tree.leaves(
        specs[1], is_leaf=lambda x: isinstance(x, PartitionSpec))]


@pytest.mark.parametrize("arch,shape,mesh", DECODE_CELLS)
def test_decode_state_specs_equal_the_reference_kv_spec(arch, shape, mesh):
    """``decode_state_specs`` gives every leaf of every production decode
    cell's state the layout the reference's dry-run gives it."""
    shp, axes = PRODUCTION[mesh == "multi"]
    state = api.input_specs(get_arch(arch), SHAPES[shape])["state"]
    specs = decoding.decode_state_specs(state, ctx_for_mesh(Mesh(axes,
                                                                 shp)))
    got = [tuple(p) for p in _tree.flatten_up_to(state, specs)]
    want = _ref_state_specs(arch, shape, mesh == "multi")
    assert got == want
    kv = [p for (path, _), p in zip(_tree.flatten(state), got)
          if "kv" in path]
    assert all("model" in p for p in kv)


def test_cli_lists_every_shape_and_the_66_cells():
    """The CLI's default shapes are all four; ``--all --mesh both`` lists
    the reference's 66 cells: 10 archs x 3 shapes + 3 sub-quadratic
    archs x ``long_500k``, each on both meshes."""
    cells = dryrun.list_cells(every=True)
    assert len(cells) == 66 == len(set(cells))
    assert {s for _, s, _ in cells} == set(SHAPES) == {
        "train_4k", "prefill_32k", "decode_32k", "long_500k"}
    assert {s for _, s, _ in dryrun.list_cells("h2o-danube-1.8b")} == \
        set(SHAPES)
    assert sorted(a for a, s, m in cells
                  if s == "long_500k" and m == "single") == sorted(
        a for a in JARCHS if get_arch(a).subquadratic)


def test_a_group_already_up_is_refused(tmp_path, no_group_left):
    with dryrun.placeholder_group(2):
        with pytest.raises(RuntimeError, match="already up"):
            dryrun.run_cell("h2o-danube-1.8b", "train_4k", "single",
                            str(tmp_path))
        assert dist.get_world_size() == 2


def test_dryrun_cli_end_to_end(tmp_path):
    """The dry-run CLI traces and records a cell in a fresh process, as
    the reference's ``test_dryrun_cli_end_to_end`` runs its own, with
    danube in place of the reference's xlstm-125m, whose full-width
    sLSTM step loop takes longer to trace than the 300 s limit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    variant = json.dumps({"tag": "clitest", "mesh_shape": [2, 4]})
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "h2o-danube-1.8b", "--shape", "train_4k", "--mesh", "single",
         "--out", str(tmp_path), "--force", "--variant", variant],
        env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1/1 cells OK" in r.stdout
    [path] = tmp_path.glob("*__clitest.json")
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["flops_per_device"] > 0
    assert rec["mesh_shape"] == {"data": 2, "model": 4}


def test_inspect_lists_collectives_heaviest_first(no_group_left):
    with dryrun.placeholder_group(8):
        fn, args = dryrun.build_cell(
            tiny_config(get_arch("llama4-scout-17b-a16e")), TINY,
            make_mesh((2, 4), ("data", "model"), "cpu"), {}, torch.float32)
        ops_ = hlo_analysis.trace(fn, *args).ops
    rows = inspect_hlo.inspect(ops_, top=10 ** 6)
    totals = [r["bytes_total"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    assert sum(r["count"] for r in rows) == sum(1 for op in ops_ if op.coll)
    deep = hlo_analysis.analyze(ops_)
    assert abs(sum(totals) - deep["coll_total"]) <= 1e-6 * deep["coll_total"]
    assert {r["kind"] for r in rows} == {"all-gather", "all-reduce",
                                         "reduce-scatter", "all-to-all"}
    assert all(r["block"] for r in rows)
    assert len(inspect_hlo.inspect(ops_, top=3)) == 3


# --------------------------------------------------------------------------- #
# the memory tracker
# --------------------------------------------------------------------------- #
def test_memory_counts_a_view_once_and_frees():
    a = torch.empty(1000, device="meta")            # 4,000 bytes

    def f(x):
        t = x * 2
        u = t + 1
        v = u.view(10, 100)[2:]                     # a view of u
        del t
        w = v * 3
        del w
        return v
    tr = hlo_analysis.trace(f, a)
    assert tr.arg_bytes == 4000
    assert tr.peak_bytes == 4000 * 3          # a, t, u: then t freed, w
    assert tr.out_bytes == 4000               # v is u's storage


def test_memory_keeps_what_autograd_saves_until_the_backward():
    w = torch.empty(256, 256, device="meta", requires_grad=True)
    x = torch.empty(64, 256, device="meta")

    def f(w, x):
        h = torch.tanh(x @ w)                       # saves its output
        loss = (h @ w).sum()
        del h
        (g,) = torch.autograd.grad(loss, [w])
        return g
    tr = hlo_analysis.trace(f, w, x)
    assert tr.arg_bytes == (256 * 256 + 64 * 256) * 4
    # tanh's output lives past ``del h`` until the backward frees it
    assert tr.peak_bytes - tr.arg_bytes >= 2 * 64 * 256 * 4
    assert tr.out_bytes == 256 * 256 * 4


def test_arguments_are_the_state_and_the_batch():
    """The one-card step's arguments: the parameters and two float32
    moments each, the counters, the tokens and targets; its outputs hold
    a new state beside the old one (nothing is donated)."""
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    fn, args = dryrun.build_cell(cfg, TINY, None, {}, torch.float32)
    n = sum(t.numel() for t in _tree.leaves(args[0]["params"]))
    counters = sum(t.numel() * t.element_size()
                   for t in _tree.leaves(args[0]) if t.dim() == 0)
    rec = dryrun.trace_step(fn, args)
    assert rec["argument_size_in_bytes"] == \
        3 * 4 * n + counters + 2 * TINY.global_batch * TINY.seq_len * 4
    assert rec["output_size_in_bytes"] >= 3 * 4 * n


# --------------------------------------------------------------------------- #
# the meta path of the kernel wrappers
# --------------------------------------------------------------------------- #
def test_meta_tensors_take_the_cards_path():
    meta, cpu = torch.device("meta"), torch.device("cpu")
    assert ops.resolve_impl("auto", meta) == "cuda"
    assert ops.resolve_impl("cuda", meta) == "cuda"
    assert ops.resolve_impl("ref", meta) == "ref"
    assert ops.resolve_impl("auto", cpu) == "ref"
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.resolve_impl("cuda", cpu)
    with pytest.raises(RuntimeError, match="meta tensors only"):
        meta_launch("x", 1.0, [torch.zeros(1)])


def test_meta_path_counts_launches_and_variants(no_build):
    ops.reset_launches()
    jfa.VARIANT_LAUNCHES.reset()
    mssd.VARIANT_LAUNCHES.reset()
    q = torch.empty((1, 4, 64, 32), device="meta")
    out = ops.flash_attention(q, q, q)
    assert out.shape == q.shape and out.device.type == "meta"
    x = torch.empty((1, 64, 4, 16), device="meta")
    dt = torch.empty((1, 64, 4), device="meta")
    a = torch.empty(4, device="meta")
    b = torch.empty((1, 64, 1, 16), device="meta")
    y, h = ops.ssd(x, dt, a, b, b, chunk=32)
    assert y.shape == x.shape and h.shape == (1, 4, 16, 16)
    assert h.dtype == torch.float32
    counts = ops.LAUNCHES.read()
    assert counts["flash_attention"] == 1 and counts["ssd_scan"] == 1
    assert jfa.VARIANT_LAUNCHES["mma_3xtf32"] == 1
    assert mssd.VARIANT_LAUNCHES["mma_3xtf32"] == 1
    ops.reset_launches()


def test_meta_path_keeps_the_refusals():
    """What the card refuses, the dry-run refuses: a backward that does
    not take the head dim or widths, a kernel without a backward under
    grad, a kernel with no meta stand-in."""
    q = torch.empty((1, 4, 64, 20), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(q, q, q)
    x = torch.empty((1, 64, 4, 160), device="meta", requires_grad=True)
    dt = torch.empty((1, 64, 4), device="meta")
    a = torch.empty(4, device="meta")
    b = torch.empty((1, 64, 1, 16), device="meta")
    with pytest.raises(ValueError, match="does not take"):
        ops.ssd(x, dt, a, b, b, chunk=32)
    m = torch.empty((8, 8), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.staged_matmul(m, m)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.staged_matmul(m.detach(), m.detach())


def test_ssd_backward_scratch_and_work():
    """The meta path's scratch size is the C launcher's ``Scratch``
    (held equal on the card by ``chip_smoke.py``); ``bwd_work`` keeps
    the figures of the SSD backward rows."""
    B, T, H, P, G, N, L = 2, 4096, 64, 64, 1, 64, 256
    nc = T // L
    assert mssd.bwd_scratch_floats(B, T, H, P, G, N, L) == \
        B * H * nc * N * P + 2 * B * T * H * N + 4 * B * H * T + 2 * B * H * nc
    assert mssd.bwd_scratch_floats(B, T, H, 200, G, N, L) == -1
    flops, nbytes = mssd.bwd_work(B, T, H, G, N, P, L, 4, False)
    assert flops == float(B * H) * (nc * L * (L + 1) * (3 * N + 2 * P)
                                    + 2.0 * L * N * P * 4 * (nc - 1))
    assert nbytes > 0
    assert mssd.flops(1, 1024, 64, 64, 64, 256) == float(64) * (
        4 * 256 * 257 * 128 + 2.0 * 256 * 64 * 64 * 7)


# --------------------------------------------------------------------------- #
# abstract_params against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_abstract_params_match_the_reference(name):
    jp = japi.abstract_params(jtiny(JARCHS[name]))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): (tuple(v.shape), np.dtype(v.dtype).name)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {_tree.key(p): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in _tree.flatten(
               api.abstract_params(tiny_config(get_arch(name))))}
    assert got == want
    assert all(v.device.type == "meta" for v in _tree.leaves(
        api.abstract_params(tiny_config(get_arch(name)), torch.bfloat16)))


# --------------------------------------------------------------------------- #
# what the bfloat16 cells found
# --------------------------------------------------------------------------- #
BF16_LOSS_TOL = 1e-2         # relative: bfloat16 compute, sums reordered
BF16_NORM_TOL = 5e-2


def test_xlstm_trains_in_bfloat16_as_the_reference():
    """The dry-run's bfloat16 cells found the sLSTM's recurrent product
    refusing a bfloat16 weight against its float32 carry (the reference's
    einsum promotes): tiny xLSTM's bfloat16 loss and gradient norm on
    the reference's parameters against ``jax.grad`` of the reference's
    ``loss_fn``."""
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_jax
    jcfg = jtiny(JARCHS["xlstm-125m"])
    cfg = tiny_config(get_arch("xlstm-125m"))
    jparams = japi.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, single_device_ctx(),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.bfloat16)[0])(jparams)
    jnorm = float(np.sqrt(sum(float(jnp.sum(g.astype(jnp.float32) ** 2))
                              for g in jax.tree.leaves(jgrads))))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    leaves = [t.requires_grad_(True) for t in _tree.leaves(params)]
    loss, _ = transformer.loss_fn(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.bfloat16)
    grads = torch.autograd.grad(loss, leaves)
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        BF16_LOSS_TOL * abs(float(jloss))
    assert abs(norm - jnorm) <= BF16_NORM_TOL * jnorm, (norm, jnorm)
