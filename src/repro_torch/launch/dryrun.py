"""Multi-pod dry-run (``repro.launch.dryrun``): trace one step of every
(architecture x input shape x mesh) cell on the ``meta`` device, as rank 0
of a placeholder process group of the mesh's size.

The reference lowers and compiles each cell against ``ShapeDtypeStruct``s
on 256 or 512 placeholder host devices.  The port has no compiler: one
process joins a placeholder group (the ``fake`` backend of
``torch.distributed``, whose collectives move nothing) of the mesh's
size as rank 0, builds the mesh over it, and runs rank 0's train step on
meta tensors of its blocks under ``hlo_analysis.trace``.  That proves the
sharding coherent (every shape meets its collective), counts the step's
FLOPs, bytes and collectives (``hlo_analysis.analyze``) and follows its
memory as the card's allocator would hold it.  The kernels take the
card's path on meta tensors: each wrapper checks its inputs and picks
its variant as on the card, allocates what it allocates there and counts
its launch, but launches nothing.

Each cell writes one JSON record.  Keys kept from the reference:
``flops_per_device``, ``dot_bytes_per_device``,
``collective_bytes_per_device``, ``collective_total_per_device``,
``collective_counts``, ``arg_bytes_per_device`` and
``argument_size_in_bytes`` (the rank's state and batch blocks),
``output_size_in_bytes`` (the new state and the figures),
``temp_size_in_bytes`` (the traced peak of live storages less the
arguments: the old and new state and what autograd saves all count, a
view once), ``mesh_shape``, ``ok``, ``error``, ``total_s``.  New:
``trace_s``, ``trace_ops`` (ops dispatched) and ``kernel_launches`` (the
hand kernels' launches, by name).  The XLA-only keys (``lower_s``,
``compile_s``, ``xla_flops_per_device``, ``xla_bytes_per_device``,
``trip_counts``, ``collective_bytes_raw``, ``hlo_lines``,
``generated_code_size_in_bytes``) have no counterpart.  A train cell's
state is not donated: the old state stays live beside the new one, as on
the card.

The serve shapes trace ``models.decoding``'s ``prefill`` (``prefill_32k``:
the parameters and this rank's batch block of prompts, the decode cache
sized to the prompt) and ``decode_step`` (``decode_32k``, ``long_500k``:
one token against a cache of the shape's length, the state split by
``decoding.decode_state_specs``, tokens and lengths over the batch axes),
as the reference's ``build_cell`` builds them: parameters in float32, or
bfloat16 under ``serve_bf16``, cut by ``train.steps.param_specs``.  Both
run under ``torch.no_grad()``, so nothing is saved for a backward.  The
decode step updates its state in place (the reference donates it), so
the state counts once, among the arguments.

Usage (the CPU suffices; no card, no environment variable):
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] \
      [--force]
Outputs one JSON per cell under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Optional, Union

import torch
import torch.distributed as dist

from .. import _tree
from ..configs import ARCHS, SHAPES, ArchConfig, ShapeConfig, eligible, \
    get_arch
from ..kernels import ops
from ..models import api as model_api
from ..models import decoding
from ..optim import adamw
from ..parallel.sharding import Mesh
from ..train import steps as steps_mod
from . import hlo_analysis
from .mesh import PRODUCTION, ctx_for_mesh, make_mesh

AXES = ("pod", "data", "model")


@contextlib.contextmanager
def placeholder_group(world_size: int):
    """This process as rank 0 of a placeholder group of ``world_size``
    ranks (the ``fake`` backend: collectives move nothing).  Raises if a
    process group is already up; destroys its own on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry-run "
                           "starts its own placeholder group")
    # registers the "fake" backend, which torch ships under its
    # non-public testing package
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
               mesh: Optional[Mesh], variant: Optional[dict] = None,
               compute_dtype=torch.bfloat16):
    """Returns ``(fn, args)``: the step of the cell (the train step, the
    prefill or the decode step, by the shape's kind) and rank 0's meta
    arguments (its blocks, each in a storage of its own): ``(state,
    batch)`` to train, ``(params, batch)`` to prefill, ``(params, state,
    tokens, lengths)`` to decode.  ``mesh=None``: the unsharded one-card
    step.  ``variant``: ``ParallelCtx`` overrides (``remat``, ``fsdp``,
    ``use_ep``, ``seq_parallel_decode``, ``bf16_weight_gather``,
    ``jet_collectives``, ``jet_window``), ``int8_moments`` (default: more
    than 50 B parameters), ``compressed_pod_grads`` and ``accum`` (the
    batch in the microbatched layout ``[A, B/A, ...]``) to train, and
    ``serve_bf16`` (bfloat16 parameters) to serve, as the reference's."""
    variant = variant or {}
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shape = shape if isinstance(shape, ShapeConfig) else SHAPES[shape]
    remat = variant.get("remat", "full")
    ctx = None if mesh is None else ctx_for_mesh(
        mesh, remat=remat, fsdp=variant.get("fsdp", True),
        use_ep=variant.get("use_ep", True),
        seq_parallel_decode=variant.get("seq_parallel_decode", True),
        bf16_weight_gather=variant.get("bf16_weight_gather", False),
        jet_collectives=variant.get("jet_collectives", False),
        jet_window=variant.get("jet_window", 4))
    inputs = model_api.input_specs(cfg, shape, compute_dtype)
    if shape.kind != "train":
        fn, args = _serve_cell(cfg, shape, ctx, variant, inputs,
                               compute_dtype)
        # a block is a view of the whole meta tensor: its own storage
        return fn, _tree.tree_map(torch.Tensor.clone, args)
    big = cfg.param_counts()[0] > 50e9
    opt_cfg = adamw.OptConfig(
        int8_moments=variant.get("int8_moments", big),
        compressed_pod_grads=variant.get("compressed_pod_grads", False))
    accum = int(variant.get("accum", 1))
    batch = inputs
    if accum > 1:
        batch = _tree.tree_map(
            lambda s: s.reshape((accum, s.shape[0] // accum)
                                + tuple(s.shape[1:])), batch)
    state = steps_mod.abstract_state(cfg, opt_cfg)
    if ctx is not None:
        state = steps_mod.shard_state(state, ctx)
        batch = steps_mod.shard_batch(batch, ctx, accum)
    # a block is a view of the whole meta tensor: give it its own storage
    state, batch = _tree.tree_map(torch.Tensor.clone, (state, batch))
    fn = steps_mod.make_train_step(cfg, opt_cfg, compute_dtype,
                                   accum_steps=accum, remat=remat, ctx=ctx)
    return fn, (state, batch)


def _serve_cell(cfg: ArchConfig, shape: ShapeConfig, ctx, variant: dict,
                inputs: dict, compute_dtype):
    """The prefill or decode step of a serve cell and rank 0's blocks of
    its arguments (views; :func:`build_cell`)."""
    params = model_api.abstract_params(
        cfg, torch.bfloat16 if variant.get("serve_bf16") else torch.float32)
    p_specs = None
    if ctx is not None:
        p_specs = steps_mod.param_specs(params, ctx)
        params = ctx.shard_tree(params, p_specs)
    if shape.kind == "prefill":
        batch = inputs if ctx is None else steps_mod.shard_batch(inputs, ctx)

        @torch.no_grad()
        def prefill(params, batch):
            return model_api.prefill(
                params, cfg, batch["tokens"], batch.get("patches"),
                max_len=shape.seq_len, compute_dtype=compute_dtype, ctx=ctx,
                specs=p_specs)
        return prefill, (params, batch)
    state, tokens, lengths = (inputs[k] for k in ("state", "tokens",
                                                   "lengths"))
    s_specs = None
    if ctx is not None:
        s_specs = decoding.decode_state_specs(state, ctx)
        state = ctx.shard_tree(state, s_specs)
        tokens, lengths = steps_mod.shard_batch((tokens, lengths), ctx)

    @torch.no_grad()
    def decode(params, state, tokens, lengths):
        return model_api.decode_step(
            params, cfg, state, tokens, lengths, compute_dtype, ctx=ctx,
            specs=p_specs, state_specs=s_specs)
    return decode, (params, state, tokens, lengths)


def trace_step(fn, args) -> dict:
    """Trace ``fn(*args)`` and return the record's figures (module
    docstring); the kernel launches are the call's own (``ops.LAUNCHES``
    after less before; the counts are not reset)."""
    before = ops.LAUNCHES.read()
    tr = hlo_analysis.trace(fn, *args)
    launches = {k: v - before[k] for k, v in ops.LAUNCHES.read().items()}
    deep = hlo_analysis.analyze(tr.ops)
    return {"flops_per_device": deep["dot_flops"],
            "dot_bytes_per_device": deep["dot_bytes"],
            "collective_bytes_per_device": deep["coll"],
            "collective_total_per_device": deep["coll_total"],
            "collective_counts": deep["coll_counts"],
            "arg_bytes_per_device": tr.arg_bytes,
            "argument_size_in_bytes": tr.arg_bytes,
            "output_size_in_bytes": tr.out_bytes,
            "temp_size_in_bytes": tr.peak_bytes - tr.arg_bytes,
            "trace_s": tr.seconds, "trace_ops": len(tr.ops),
            "kernel_launches": launches}


def cell_mesh(mesh_kind: str, variant: dict):
    """(shape, axes) of a cell's mesh: ``variant["mesh_shape"]`` (axes the
    last of pod, data, model) or the production mesh."""
    if variant.get("mesh_shape"):
        shape = tuple(int(v) for v in variant["mesh_shape"])
        return shape, AXES[-len(shape):]
    return PRODUCTION[mesh_kind == "multi"]


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             out_dir: str, variant=None, force: bool = False) -> dict:
    variant = variant or {}
    vtag = ("__" + variant["tag"]) if variant.get("tag") else ""
    out_path = os.path.join(
        out_dir, f"{arch_name}__{shape_name}__{mesh_kind}{vtag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    shape, axes = cell_mesh(mesh_kind, variant)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": dict(zip(axes, shape)),
           "variant": {k: v for k, v in variant.items() if k != "tag"},
           "tag": variant.get("tag", "")}
    t0 = time.time()
    with placeholder_group(math.prod(shape)):
        try:
            mesh = make_mesh(shape, axes, "cpu")
            fn, args = build_cell(arch_name, shape_name, mesh, variant)
            rec.update(trace_step(fn, args))
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 — record the failure verbatim
            rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:]})
    rec["total_s"] = round(time.time() - t0, 2)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def list_cells(arch: Optional[str] = None, shape: Optional[str] = None,
               mesh: str = "both", every: bool = False) -> list:
    """The CLI's cells, ``(arch, shape, mesh kind)``: every arch and every
    shape unless one is named (``every``: all of both), each on the
    single-pod mesh, the multi-pod one or both, the ineligible
    (``long_500k`` of a quadratic arch) left out."""
    archs = list(ARCHS) if (every or not arch) else [arch]
    shapes = list(SHAPES) if (every or not shape) else [shape]
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    return [(a, s, m) for a in archs for s in shapes
            if eligible(get_arch(a), SHAPES[s]) for m in meshes]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help="default (and --all): every shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default=None,
                    help="JSON dict of ParallelCtx overrides + 'tag'")
    args = ap.parse_args()
    variant = json.loads(args.variant) if args.variant else {}
    cells = list_cells(args.arch, args.shape, args.mesh, args.all)

    n_ok = 0
    for i, (a, s, m) in enumerate(cells):
        rec = run_cell(a, s, m, args.out, variant, args.force)
        ok = rec.get("ok")
        n_ok += bool(ok)
        gf = rec.get("flops_per_device", 0) / 1e9 if ok else 0
        print(f"[{i+1}/{len(cells)}] {a} x {s} x {m}: "
              f"{'OK' if ok else 'FAIL'} "
              f"({rec['total_s']}s, {gf:.1f} GF/dev)"
              + ("" if ok else f"  {rec.get('error','')[:200]}"),
              flush=True)
    print(f"dry-run complete: {n_ok}/{len(cells)} cells OK")
    if n_ok < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
