"""The port's data pipeline, checkpoints and fault-tolerant loop on the
CPU against the reference.

* The pipeline: batches bit-equal to the reference's (plain tokens,
  musicgen's codebooks, vision's patches, a 2-process split) and a
  cursor resume.
* Checkpoints: round trip, ``keep_last``, no ``.tmp`` left, the async
  saver's snapshot; a port checkpoint restored by
  ``repro.checkpoint.ckpt.restore`` and a reference one by the port's,
  both equal leaf for leaf (int8 moment codes included).
* The loop: a crash at step 4 and a resume land on the uninterrupted
  run's final loss, bit for bit (the CPU runs the same operations in the
  same order); the port's and the reference's loops from one carried
  state log the same losses within the train step's 1e-5; a preemption
  writes a checkpoint at the step boundary; the straggler monitor.
* The launcher: ``--tiny --device cpu`` trains; ``--mesh 2x4`` and
  ``--remat layer_out`` raise (mesh knobs).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCHS, tiny_config as jtiny
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.parallel.sharding import single_device_ctx
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch import _tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeConfig, get_arch, tiny_config
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import state_from_jax
from repro_torch.optim import adamw
from repro_torch.train import loop, steps

torch.set_num_threads(1)

LOSS_TOL = 1e-5     # tests/test_torch_optim.py: a train step's loss


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "musicgen-large",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("procs", [1, 2])
def test_batches_bit_equal_the_reference(arch, procs):
    cfg = tiny_config(get_arch(arch))
    kw = dict(vocab_size=cfg.vocab_size, global_batch=4, seq_len=24,
              num_codebooks=cfg.num_codebooks, num_patches=cfg.num_patches,
              d_model=cfg.d_model, seed=3, process_count=procs)
    for idx in range(procs):
        got = pipeline.SyntheticPipeline(pipeline.PipelineConfig(
            process_index=idx, **kw))
        want = jpipe.SyntheticPipeline(jpipe.PipelineConfig(
            process_index=idx, **kw))
        for _ in range(3):
            g, w = got.next_batch(), want.next_batch()
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])


def test_for_arch_and_cursor_resume():
    shape = ShapeConfig("s", "train", 16, 2)
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    a = pipeline.for_arch(cfg, shape, seed=1)
    want = jpipe.for_arch(jtiny(ARCHS["h2o-danube-1.8b"]),
                          JShapeConfig("s", "train", 16, 2), seed=1)
    batches = [a.next_batch() for _ in range(5)]
    for b in batches:
        np.testing.assert_array_equal(b["tokens"], want.next_batch()["tokens"])
    resumed = pipeline.SyntheticPipeline(a.cfg, cursor=3).next_batch()
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(batches[3][k], resumed[k])
    with pytest.raises(ValueError, match="divide"):
        pipeline.SyntheticPipeline(dataclasses.replace(a.cfg,
                                                       process_count=3))


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_roundtrip_keep_last_and_atomic_commit(tmp_path):
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3),
                                                          dtype=torch.int32)},
            "t": (torch.zeros(2, dtype=torch.int8), torch.tensor(7))}
    for step in (1, 2, 3, 4):
        ckpt.save(tree, str(tmp_path), step, keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    got, extra = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert extra == {}
    for (p, g), (_, w) in zip(_tree.flatten(got), _tree.flatten(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w), p
    assert isinstance(got["t"], tuple)
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        manifest = json.load(f)
    assert sorted(manifest["leaves"]) == ["a", "b/c", "t/0", "t/1"]
    assert manifest["leaves"]["a"]["file"] == "leaf_00000.npy"
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree, device="cpu")


def test_async_saver_snapshots_before_returning(tmp_path):
    saver = ckpt.AsyncSaver()
    x = torch.arange(10.0)
    saver.save({"x": x}, str(tmp_path), 5, extra={"cursor": 5})
    x.add_(100.0)                     # the caller moves on at once
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 5
    got, extra = ckpt.restore(str(tmp_path), {"x": x}, device="cpu")
    assert torch.equal(got["x"], torch.arange(10.0))
    assert extra == {"cursor": 5}
    assert saver.last_path.endswith("step_00000005")


def _states():
    """A reference train state with int8 moments after one step, and the
    port's copy of it."""
    jcfg = dataclasses.replace(jtiny(ARCHS["h2o-danube-1.8b"]), num_layers=2)
    cfg = dataclasses.replace(tiny_config(get_arch("h2o-danube-1.8b")),
                              num_layers=2)
    jo = jadamw.OptConfig(int8_moments=True)
    jstate = jsteps.init_state(jcfg, jo, jax.random.key(0))
    data = jpipe.SyntheticPipeline(jpipe.PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=8))
    jstate, _ = jax.jit(jsteps.make_train_step(
        jcfg, single_device_ctx(), jo, jnp.float32))(
        jstate, {k: jnp.asarray(v) for k, v in data.next_batch().items()})
    return cfg, jstate, state_from_jax(_np(jstate), cfg, "cpu")


def _equal(torch_tree, jax_tree):
    flat = _tree.flatten(torch_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [_tree.key(p) for p, _ in flat] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jflat]
    for (p, g), (_, w) in zip(flat, jflat):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, p
        np.testing.assert_array_equal(g.numpy(), w)


def test_checkpoints_are_readable_both_ways(tmp_path):
    cfg, jstate, state = _states()
    assert state["opt"]["m"]["pattern"][0]["attn"]["wq"]["q"].dtype == \
        torch.int8
    _equal(state, jstate)
    # the port's checkpoint through the reference's restore
    ckpt.save(state, str(tmp_path / "port"), 1, extra={"step": 1})
    got, extra = jckpt.restore(str(tmp_path / "port"), jstate)
    assert extra == {"step": 1}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, jstate)
    # the reference's checkpoint through the port's restore, into the
    # abstract state (meta tensors)
    jckpt.save(jstate, str(tmp_path / "ref"), 1)
    like = steps.abstract_state(cfg, adamw.OptConfig(int8_moments=True))
    got, _ = ckpt.restore(str(tmp_path / "ref"), like, device="cpu")
    _equal(got, jstate)


# --------------------------------------------------------------------------- #
# the loop
# --------------------------------------------------------------------------- #
class _Boom(RuntimeError):
    pass


def _tiny():
    return dataclasses.replace(tiny_config(get_arch("h2o-danube-1.8b")),
                               num_layers=2)


def _data(cfg, cursor=0):
    return pipeline.SyntheticPipeline(pipeline.PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=16), cursor)


def test_crash_and_resume_is_bitwise(tmp_path):
    cfg = _tiny()
    opt = adamw.OptConfig(lr=1e-3, total_steps=6)

    def lcfg(name):
        return loop.LoopConfig(total_steps=6, ckpt_every=2, log_every=1,
                               ckpt_dir=str(tmp_path / name))
    ref = loop.run(cfg, opt, lcfg("ref"), _data(cfg),
                   torch.Generator().manual_seed(0), device="cpu")
    resumed = []

    def injector(step):
        if step == 4 and not resumed:
            raise _Boom("simulated node failure")
    with pytest.raises(_Boom):
        loop.run(cfg, opt, lcfg("crash"), _data(cfg),
                 torch.Generator().manual_seed(0), fault_injector=injector,
                 device="cpu")
    resumed.append(True)
    out = loop.run(cfg, opt, lcfg("crash"), _data(cfg), None,
                   fault_injector=injector, device="cpu")
    assert out["final_step"] == 6
    # the fault let step 4's checkpoint commit: the restart resumes there
    assert [h["step"] for h in out["history"]] == [5, 6]
    assert out["history"][-1]["loss"] == ref["history"][-1]["loss"]
    for g, w in zip(_tree.leaves(out["state"]), _tree.leaves(ref["state"])):
        assert torch.equal(g, w)


def test_preemption_checkpoints_the_step_boundary(tmp_path):
    cfg = _tiny()

    def injector(step):
        if step == 3:
            raise KeyboardInterrupt
    lcfg = loop.LoopConfig(total_steps=6, ckpt_every=100,
                           ckpt_dir=str(tmp_path))
    with pytest.raises(KeyboardInterrupt):
        loop.run(cfg, adamw.OptConfig(), lcfg, _data(cfg),
                 torch.Generator().manual_seed(0), fault_injector=injector,
                 device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 3
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"step": 3, "cursor": 3}


@pytest.mark.parametrize("accum", [1, 2])
def test_loop_matches_the_reference_loop(tmp_path, accum):
    jcfg = dataclasses.replace(jtiny(ARCHS["h2o-danube-1.8b"]), num_layers=2)
    cfg = _tiny()
    jo = jadamw.OptConfig(lr=1e-3, total_steps=4)
    jstate = jsteps.init_state(jcfg, jo, jax.random.key(0))
    state = state_from_jax(_np(jstate), cfg, "cpu")
    kw = dict(total_steps=4, ckpt_every=2, log_every=1)
    want = jloop.run(jcfg, single_device_ctx(), jo,
                     jloop.LoopConfig(ckpt_dir=str(tmp_path / "ref"), **kw),
                     jpipe.SyntheticPipeline(jpipe.PipelineConfig(
                         vocab_size=cfg.vocab_size, global_batch=2,
                         seq_len=16)), jax.random.key(0), state=jstate,
                     accum_steps=accum)
    got = loop.run(cfg, adamw.OptConfig(lr=1e-3, total_steps=4),
                   loop.LoopConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                   _data(cfg), None, state=state, accum_steps=accum,
                   device="cpu")
    assert got["final_step"] == want["final_step"] == 4
    assert [h["step"] for h in got["history"]] == [1, 2, 3, 4]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL * abs(w["loss"])
    # both wrote the same checkpoint layout
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_straggler_monitor_flags_outliers():
    mon = loop.StragglerMonitor(factor=3.0, ewma=0.9)
    assert not mon.observe(1.0)
    for _ in range(5):
        assert not mon.observe(1.0)
    assert mon.observe(10.0)                   # 10x the EWMA -> flagged
    assert mon.flags == 1


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "h2o-danube-1.8b", "--tiny", "--device",
                       "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)])
    assert "final step 2" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x4"], "A4"), (["--remat", "layer_out"], "mesh knob")])
def test_launcher_refuses_mesh_knobs(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        launch_train.main(["--arch", "h2o-danube-1.8b", "--tiny",
                           "--device", "cpu", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)] + flags)
