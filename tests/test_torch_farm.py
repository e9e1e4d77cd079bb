"""The port's sweep farm against the reference's, on the CPU.

* the chunk plan, the named-grid registry and the new scenarios
  (``mixed_fleet``, ``storage_mix``, ``single_pair``) equal the
  reference's; the scenarios run in float64 within 1e-9 of its ``numpy``
  backend;
* ``envelope()`` and ``structure_key`` equal the reference's, and a
  chunk's key equals the full grid's exactly where the reference's does;
* ``FabricRun.load`` re-arms a built run: a run loaded with chunk B
  after chunk A equals a fresh run on B bit for bit;
* ``run_farm(device="cpu")`` equals the monolithic run bit for bit
  (padded remainder, a fault grid split mid-grid, a sparse pod grid),
  float64 within 1e-9 of the reference's ``run_farm(backend="numpy")``,
  and a second pass builds no run;
* artifacts: round trip, resume, shards across the two packages, the
  spawn pool.

The card's side (captured graphs re-armed by ``load``) is in
``tests/test_torch_cuda.py``.
"""
import math
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from repro.fabric import artifacts as RA
from repro.fabric import scenarios as SC
from repro.fabric.cc import CcConfig as RefCc
from repro.fabric.farm import run_farm as ref_farm
from repro.fabric.faults import FaultConfig as RefFault
from repro.fabric.vector import FabricSweepParams as RefParams
from repro.fabric.vector import run_fabric_sweep as ref_sweep
from repro_torch.fabric import CcConfig, FaultConfig, fused
from repro_torch.fabric import artifacts as A
from repro_torch.fabric import scenarios as TSC
from repro_torch.fabric import vector as V
from repro_torch.fabric.farm import GridSpec, main, run_farm
from repro_torch.fabric.vector import (FabricRun, FabricSweepParams,
                                       run_fabric_sweep)

torch.set_num_threads(1)

SIM_S = 0.0003          # 300 ticks
TOL = 1e-9              # float64 vs the reference's numpy backend
F64 = torch.float64


def _incast(M, n=8, sim_time_s=SIM_S):
    return M.incast_grid(burst_mb=tuple(0.25 * (i + 1)
                                        for i in range(n // 4)),
                         n_senders=4, sim_time_s=sim_time_s)[0][:n]


def _hetero(M, cc, fault):
    """The reference's heterogeneous grid (``tests/test_farm.py``): the
    first half carries Timely + faults, the second half is plain."""
    scens = _incast(M)
    for sc in scens[:4]:
        sc.fabric.cc = cc(algo="timely")
        sc.fabric.faults = fault(loss_rate=1e-4, seed=7)
    return scens


def _routing(M):
    return M.routing_grid(modes=("static_ecmp", "adaptive", "spray"),
                          fail_at_us=(math.inf, 100.0), n_senders=4,
                          burst_mb=0.5, sim_time_s=SIM_S)[0]


def _pods(M):
    """Sparse pod incast with a failure window on half its points."""
    scens = M.pod_incast_grid(mode=("jet", "ddio"), pfc=(False, True),
                              hosts_per_leaf=2, sim_time_s=SIM_S)[0]
    for s in scens[:2]:
        s.topology.fail_link("p1s0", "ss0", at_us=100.0)
    return scens


# name -> (port grid, reference grid, sparse)
KEY_GRIDS = {
    "incast": (lambda: _incast(TSC), lambda: _incast(SC), False),
    "hetero": (lambda: _hetero(TSC, CcConfig, FaultConfig),
               lambda: _hetero(SC, RefCc, RefFault), False),
    "routing": (lambda: _routing(TSC), lambda: _routing(SC), False),
    "pods_fail": (lambda: _pods(TSC), lambda: _pods(SC), True),
}


def _identical(a: dict, b: dict) -> list:
    """Keys whose arrays differ (NaN and inf in the same places)."""
    return sorted(set(a) ^ set(b)) + [
        k for k in b if k in a and not np.array_equal(
            np.asarray(a[k]), np.asarray(b[k]),
            equal_nan=np.asarray(b[k]).dtype.kind == "f")]


def _close(got: dict, want: dict, tol: float = TOL) -> None:
    for k in want:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        assert a.shape == b.shape, k
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        m = np.isfinite(b)
        assert np.allclose(a[m], b[m], rtol=tol, atol=0.0), k


# --------------------------------------------------------------------------- #
# chunk plan, registry, scenarios
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,chunk", [(1, 1), (1, 16), (7, 4), (8, 4),
                                     (23, 8), (64, 16), (64, 20), (3, 2),
                                     (100, 7), (5, 64)])
def test_chunk_plan_is_the_reference_plan(n, chunk):
    plan = TSC.chunk_plan(n, chunk)
    assert plan == SC.chunk_plan(n, chunk)
    assert [i for e in plan for i in range(e["start"], e["stop"])] \
        == list(range(n))
    assert len({e["padded"] for e in plan}) <= 2


@pytest.mark.parametrize("n,chunk", [(0, 8), (8, 0), (8, -1)])
def test_chunk_plan_rejects_bad_input(n, chunk):
    with pytest.raises(ValueError):
        TSC.chunk_plan(n, chunk)


@pytest.mark.parametrize("name", sorted(SC.GRIDS))
def test_named_grid_is_the_reference_grid(name):
    scens, points = TSC.build_grid(name, quick=True)
    ref, ref_points = SC.build_grid(name, quick=True)
    assert [s.name for s in scens] == [s.name for s in ref]
    assert points == ref_points
    assert sorted(TSC.GRIDS) == sorted(SC.GRIDS)


def test_unknown_grid_raises():
    with pytest.raises(ValueError, match="unknown grid"):
        TSC.build_grid("nope")
    with pytest.raises(ValueError, match="unknown storage mix"):
        TSC.storage_mix("archive")


def _mixed(M):
    return M.mixed_fleet_grid(pool_mb=(12.0, 1.0), burst_mb=(0.5,),
                              n_senders=4, sim_time_s=0.0005)[0] \
        + [M.mixed_fleet(n_senders=4, pool_mb=2.0, burst_mb=0.5, pfc=True,
                         rnic_ecn_cnp=True, sim_time_s=0.0005)]


NEW_SCENARIOS = {
    "mixed_fleet": _mixed,
    "storage_oltp": lambda M: [M.storage_mix("oltp", mode=m,
                                             sim_time_s=0.0005)
                               for m in ("jet", "ddio")],
    "storage_olap": lambda M: [M.storage_mix("olap", mode=m,
                                             sim_time_s=0.0005)
                               for m in ("jet", "ddio")],
    "storage_backup": lambda M: [M.storage_mix("backup", mode="jet",
                                               pfc=p, sim_time_s=0.0005)
                                 for p in (False, True)],
    "single_pair": lambda M: [M.single_pair(m, sim_time_s=0.0005)
                              for m in ("jet", "ddio")],
}


@pytest.mark.parametrize("name", sorted(NEW_SCENARIOS))
def test_new_scenarios_match_reference_float64(name):
    scens = NEW_SCENARIOS[name](TSC)
    ref = NEW_SCENARIOS[name](SC)
    assert [s.name for s in scens] == [s.name for s in ref]
    got = run_fabric_sweep(scens, device="cpu", dtype=F64)
    want = ref_sweep(ref, backend="numpy")
    _close(got, want)


def test_mixed_fleet_varies_only_receiver_scalars():
    """The mixed fleet's two receivers differ in mode, pool and CNP
    source: per-receiver columns of the packing, equal to the
    reference's."""
    scens = TSC.mixed_fleet_grid(n_senders=4, sim_time_s=0.0005)[0]
    fsp = FabricSweepParams.from_scenarios(scens)
    ref = RefParams.from_scenarios(
        SC.mixed_fleet_grid(n_senders=4, sim_time_s=0.0005)[0])
    assert fsp.recv_hosts == ["h1_0", "h1_1"]
    assert fsp.pvals["jet"].tolist() == [[1.0, 0.0]] * 6
    assert len(set(fsp.pvals["pool"][:, 0].tolist())) == 3
    for k in ref.pvals:
        assert np.array_equal(fsp.pvals[k], ref.pvals[k]), k


# --------------------------------------------------------------------------- #
# envelope and structure key
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grid", sorted(KEY_GRIDS))
def test_envelope_and_structure_key_are_the_reference_ones(grid):
    mk, mk_ref, sparse = KEY_GRIDS[grid]
    scens, ref = mk(), mk_ref()
    full = FabricSweepParams.from_scenarios(scens, sparse=sparse)
    rfull = RefParams.from_scenarios(ref, sparse=sparse)
    assert full.envelope() == rfull.envelope()
    assert full.structure_key == rfull.structure_key
    env = full.envelope()
    half = len(scens) // 2
    for lo, hi in ((0, half), (half, len(scens)), (1, 2)):
        chunk = FabricSweepParams.from_scenarios(scens[lo:hi],
                                                 sparse=sparse,
                                                 envelope=env)
        rchunk = RefParams.from_scenarios(ref[lo:hi], sparse=sparse,
                                          envelope=rfull.envelope())
        assert chunk.structure_key == full.structure_key
        assert chunk.structure_key == rchunk.structure_key
        bare = FabricSweepParams.from_scenarios(scens[lo:hi],
                                                sparse=sparse)
        rbare = RefParams.from_scenarios(ref[lo:hi], sparse=sparse)
        assert bare.structure_key == rbare.structure_key
        assert (bare.structure_key == full.structure_key) \
            == (rbare.structure_key == rfull.structure_key)


def test_bare_chunk_of_a_heterogeneous_grid_changes_the_key():
    scens = _hetero(TSC, CcConfig, FaultConfig)
    full = FabricSweepParams.from_scenarios(scens)
    bare = FabricSweepParams.from_scenarios(scens[4:])
    assert full.any_cc and full.any_flt and not bare.any_cc
    assert bare.structure_key != full.structure_key
    under = FabricSweepParams.from_scenarios(scens[4:],
                                             envelope=full.envelope())
    assert under.any_cc and under.any_flt
    assert under.structure_key == full.structure_key


def test_sparse_packing_keeps_its_value_errors_under_an_envelope():
    scens = _routing(TSC)
    env = FabricSweepParams.from_scenarios(scens).envelope()
    with pytest.raises(ValueError, match="static_ecmp"):
        FabricSweepParams.from_scenarios(scens, sparse=True, envelope=env)
    msgs = TSC.message_sweep_grid(msg_kb=(16.0,), window=(4,),
                                  verb=("write",), algo=("dcqcn",),
                                  n_senders=4, sim_time_s=SIM_S)[0]
    with pytest.raises(ValueError, match="message layer"):
        FabricSweepParams.from_scenarios(_incast(TSC)[:2], sparse=True,
                                         envelope={"msg": True})
    with pytest.raises(ValueError, match="message layer"):
        FabricSweepParams.from_scenarios(msgs, sparse=True)


# --------------------------------------------------------------------------- #
# FabricRun.load
# --------------------------------------------------------------------------- #
def _ab_grid():
    """Chunk A (jet, no PFC, DCQCN) and chunk B (ddio, PFC, Timely and
    HPCC) of one grid, packed under its envelope."""
    scens = [TSC.incast(4, mode=m, burst_mb=b, pfc=p, sim_time_s=SIM_S)
             for m, p in (("jet", False), ("ddio", True))
             for b in (0.5, 1.0)]
    for s, algo in zip(scens[2:], ("timely", "hpcc")):
        s.fabric.cc = CcConfig(algo=algo)
    env = FabricSweepParams.from_scenarios(scens).envelope()
    a = FabricSweepParams.from_scenarios(scens[:2], envelope=env)
    b = FabricSweepParams.from_scenarios(scens[2:], envelope=env)
    assert a.structure_key == b.structure_key
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_load_equals_a_fresh_run(dtype):
    a, b = _ab_grid()
    run = FabricRun(a, device="cpu", dtype=dtype)
    first = run.run()
    run.load(b)
    assert run.fsp is b and run.iterations == 0
    got = run.run()
    want = FabricRun(b, device="cpu", dtype=dtype).run()
    assert _identical(got, want) == []
    # back to A: the first run again, and its results were not touched
    run.load(a)
    assert _identical(run.run(), first) == []
    assert _identical(first, FabricRun(a, device="cpu",
                                       dtype=dtype).run()) == []


def test_load_refuses_an_eager_run():
    a, b = _ab_grid()
    run = FabricRun(a, device="cpu", graph=False)
    with pytest.raises(ValueError, match="graph=False"):
        run.load(b)


def test_load_refuses_another_structure_and_adaptive():
    a, b = _ab_grid()
    run = FabricRun(a, device="cpu")
    other = FabricSweepParams.from_scenarios(_incast(TSC)[:2])
    with pytest.raises(ValueError, match="structure"):
        run.load(other)
    longer = FabricSweepParams.from_scenarios(
        _incast(TSC, sim_time_s=2 * SIM_S)[:2])
    with pytest.raises(ValueError, match="structure"):
        FabricRun(other, device="cpu").load(longer)
    three = FabricSweepParams.from_scenarios(_incast(TSC)[:3])
    with pytest.raises(ValueError, match="structure"):
        FabricRun(other, device="cpu").load(three)
    scens = TSC.incast_grid(burst_mb=(0.5,), n_senders=4,
                            sim_time_s=SIM_S)[0]
    victimless = [TSC.incast(4, mode=s.name.split("_")[1], burst_mb=0.5,
                             with_victim=False, sim_time_s=SIM_S)
                  for s in scens]
    fsp = FabricSweepParams.from_scenarios(victimless)
    ad = FabricRun(fsp, device="cpu", adaptive=fused.AdaptiveConfig())
    with pytest.raises(ValueError, match="adaptive"):
        ad.load(fsp)


def test_cached_run_builds_once_per_shape():
    a, b = _ab_grid()
    V._RUNS.clear()
    c0 = V.GRAPH_CAPTURES
    r1 = V.cached_run(a, device="cpu")
    r2 = V.cached_run(b, device="cpu")
    assert r1 is r2 and V.GRAPH_CAPTURES == c0 + 1
    V.cached_run(a, device="cpu", dtype=F64)
    assert V.GRAPH_CAPTURES == c0 + 2


# --------------------------------------------------------------------------- #
# run_farm vs the monolithic run and the reference's farm
# --------------------------------------------------------------------------- #
FARM_CASES = {
    # 7 points, chunks (4, 3 padded to 4)
    "padded": (lambda M: _incast(M)[:7], 4, [4, 4], [4, 3]),
    # counter-hash losses must not shift across a mid-grid boundary
    "faults": (lambda M: M.lossy_incast_grid(loss_rate=(0.01, 0.05),
                                             n_senders=4,
                                             sim_time_s=SIM_S)[0],
               3, [3, 1], [3, 1]),
    "pods": (lambda M: M.pod_incast_grid(hosts_per_leaf=2,
                                         sim_time_s=SIM_S)[0],
             3, [3, 1], [3, 1]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(FARM_CASES))
def test_farm_equals_monolithic_bitwise(case, dtype):
    mk, chunk, padded, real = FARM_CASES[case]
    scens = mk(TSC)
    mono = run_fabric_sweep(scens, device="cpu", dtype=dtype)
    farm = run_farm(scens, chunk_size=chunk, device="cpu", dtype=dtype,
                    artifacts=False)
    recs = farm["manifest"]["records"]
    assert [r["padded"] for r in recs] == padded
    assert [r["stop"] - r["start"] for r in recs] == real
    assert _identical(farm["results"], mono) == []
    if case == "faults":
        assert np.asarray(mono["retransmit_bytes"]).sum() > 0


def test_heterogeneous_farm_equals_monolithic_bitwise():
    scens = _hetero(TSC, CcConfig, FaultConfig)
    mono = run_fabric_sweep(scens, device="cpu")
    farm = run_farm(scens, chunk_size=4, device="cpu", artifacts=False)
    assert _identical(farm["results"], mono) == []


@pytest.mark.parametrize("case", ["padded", "faults"])
def test_farm_float64_matches_reference_farm(case):
    mk, chunk, _, _ = FARM_CASES[case]
    got = run_farm(mk(TSC), chunk_size=chunk, device="cpu", dtype=F64,
                   artifacts=False)["results"]
    want = ref_farm(mk(SC), chunk_size=chunk, backend="numpy",
                    artifacts=False)["results"]
    _close(got, want)


def test_second_pass_builds_no_run():
    scens = _incast(TSC)[:7]
    run_farm(scens, chunk_size=4, device="cpu", artifacts=False)
    farm = run_farm(scens, chunk_size=4, device="cpu", artifacts=False)
    assert [r["captures"] for r in farm["manifest"]["records"]] == [0, 0]


def test_farm_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_farm(_incast(TSC)[:2], artifacts=False)


# --------------------------------------------------------------------------- #
# artifacts, resume, the spawn pool
# --------------------------------------------------------------------------- #
QUICK = {"sim_time_s": 0.0002, "burst_mb": (0.25, 0.5, 1.0)}


def test_artifacts_roundtrip(tmp_path):
    rdir = str(tmp_path / "run")
    out = {"m": np.arange(6, dtype=np.float64).reshape(3, 2)}
    A.save_chunk(rdir, 0, out, meta={"chunk": 0})
    results, meta = A.load_chunk(rdir, 0)
    assert meta["chunk"] == 0
    np.testing.assert_array_equal(results["m"], out["m"])
    # a corrupt shard is treated as missing (resume re-runs it)
    with open(A.chunk_path(rdir, 0), "wb") as f:
        f.write(b"garbage")
    assert A.load_chunk(rdir, 0) is None
    assert A.completed_chunks(rdir, 1) == []


def test_resume_runs_only_missing_chunks(tmp_path):
    td = str(tmp_path)
    res = run_farm("incast", quick=True, grid_overrides=QUICK,
                   chunk_size=4, device="cpu", out_dir=td)
    m = res["manifest"]
    assert m["status"] == "complete" and m["chunks"] == 3
    assert m["device"] == "cpu" and m["dtype"] == "float32"
    assert m["structure_key"] and m["envelope"]["ring_len"] > 0
    assert os.path.exists(os.path.join(res["run_dir"], "manifest.json"))
    os.remove(A.chunk_path(res["run_dir"], 1))
    res2 = run_farm("incast", quick=True, grid_overrides=QUICK,
                    chunk_size=4, device="cpu", out_dir=td,
                    run_id=res["run_id"], resume=True)
    m2 = res2["manifest"]
    assert m2["resumed_chunks"] == [0, 2]
    assert [r["chunk"] for r in m2["records"]
            if r["chunk"] not in m2["resumed_chunks"]] == [1]
    assert _identical(res["results"], res2["results"]) == []
    assert _identical(A.load_result(res["run_dir"]), res["results"]) == []


def test_resume_refuses_a_different_grid(tmp_path):
    td = str(tmp_path)
    res = run_farm("incast", quick=True, grid_overrides=QUICK,
                   chunk_size=8, device="cpu", out_dir=td)
    with pytest.raises(ValueError, match="resume mismatch"):
        run_farm("mixed_fleet", quick=True, chunk_size=8, device="cpu",
                 out_dir=td, run_id=res["run_id"], resume=True)


def test_shards_load_across_the_two_packages(tmp_path):
    scens = _incast(TSC)[:4]
    port = run_farm(scens, chunk_size=2, device="cpu", dtype=F64,
                    out_dir=str(tmp_path), run_id="port")
    ref = ref_farm(_incast(SC)[:4], chunk_size=2, backend="numpy",
                   out_dir=str(tmp_path), run_id="ref")
    for k in range(2):
        mine, meta = RA.load_chunk(port["run_dir"], k)
        theirs, rmeta = A.load_chunk(ref["run_dir"], k)
        assert meta["chunk"] == rmeta["chunk"] == k
        _close(mine, theirs)
    assert A.config_hash(scens) == RA.config_hash(_incast(SC)[:4])
    assert A.read_manifest(ref["run_dir"])["structure_key"] \
        == port["manifest"]["structure_key"]


def test_grid_spec_pickles_and_rebuilds_the_grid():
    spec = GridSpec("incast", quick=True, overrides={"n_senders": 2})
    spec2 = pickle.loads(pickle.dumps(spec))
    a, pa = spec.build()
    b, pb = spec2.build()
    assert [s.name for s in a] == [s.name for s in b] and pa == pb
    assert spec2.to_json() == {"name": "incast", "quick": True,
                               "overrides": {"n_senders": 2}}


def test_spawn_pool_equals_in_process(tmp_path):
    overrides = {"sim_time_s": 0.0002, "burst_mb": (0.25, 0.5)}
    inproc = run_farm("incast", quick=True, grid_overrides=overrides,
                      chunk_size=4, device="cpu", artifacts=False)
    pooled = run_farm("incast", quick=True, grid_overrides=overrides,
                      chunk_size=4, device="cpu", workers=2,
                      out_dir=str(tmp_path))
    recs = pooled["manifest"]["records"]
    assert len(recs) == 2 and all(r["worker"].startswith("pid")
                                  for r in recs)
    assert _identical(pooled["results"], inproc["results"]) == []


def test_raw_lists_with_workers_run_in_process():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        farm = run_farm(_incast(TSC)[:4], workers=4, chunk_size=4,
                        device="cpu", artifacts=False)
    assert any("raw scenario lists" in str(w.message) for w in rec)
    assert farm["manifest"]["records"][0]["worker"] == "inprocess"
    with pytest.raises(ValueError, match="requires artifacts"):
        run_farm("incast", quick=True, workers=2, device="cpu",
                 artifacts=False)


def test_command_line(tmp_path, capsys):
    assert main(["--grid", "incast", "--quick", "--device", "cpu",
                 "--chunk", "8", "--out-dir", str(tmp_path),
                 "--run-id", "cli"]) == 0
    out = capsys.readouterr().out
    assert "16 points, 2 chunks (0 resumed), engine=dense, device=cpu" \
        in out
    assert A.read_manifest(str(tmp_path / "cli"))["status"] == "complete"
