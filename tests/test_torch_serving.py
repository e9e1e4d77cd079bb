"""The port's serving engine and Jet service against the reference.

The port's engine and the reference's, given the same tiny zamba2
parameters and the same requests, must generate the same tokens and leave
the Jet service in the same state.  The port's pure-Python copies of the
Jet service (``JetService``, ``SlabPool``, ``ReadWindow``, the escape
ladder, the admission queues) must make the same decisions as the
reference's under the same sequence of operations.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, tiny_config as jtiny
from repro.core import datapath as jdp
from repro.core import escape as jesc
from repro.core import jet as jjet
from repro.core import pool as jpool
from repro.core import window as jwin
from repro.models import api as japi
from repro.parallel.sharding import single_device_ctx
from repro.serving import engine as jeng
from repro_torch.configs import get_arch, tiny_config
from repro_torch.core import datapath as tdp
from repro_torch.core import escape as tesc
from repro_torch.core import jet as tjet
from repro_torch.core import pool as tpool
from repro_torch.core import window as twin
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

JCFG = jtiny(ARCHS["zamba2-1.2b"])
CFG = tiny_config(get_arch("zamba2-1.2b"))
# (prompt length, max_new_tokens, QoS): more requests than lanes, mixed
# classes, requests finishing at different steps
REQUESTS = [(8, 4, 1), (16, 3, 0), (8, 5, 2), (16, 2, 1), (8, 3, 0)]


def _requests(mod, qos_cls):
    rng = np.random.default_rng(11)
    return [mod.Request(i, rng.integers(2, JCFG.vocab_size, size=t)
                        .astype(np.int32), new, qos_cls(q))
            for i, (t, new, q) in enumerate(REQUESTS)]


@pytest.fixture(scope="module")
def served():
    """Both engines, run to completion on the same params and requests."""
    jp = japi.init_params(JCFG, jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    ecfg = dict(max_lanes=2, max_len=32, eos_token=-1)
    jet_cfg = dict(pool_bytes=1 << 20)
    je = jeng.ServingEngine(JCFG, jeng.EngineConfig(**ecfg), jp,
                            single_device_ctx(),
                            jjet.JetConfig(**jet_cfg))
    te = teng.ServingEngine(CFG, teng.EngineConfig(**ecfg), tp,
                            tjet.JetConfig(**jet_cfg), device="cpu")
    jtrace, ttrace = [], []
    for eng, mod, qos, trace in ((je, jeng, jdp.QoS, jtrace),
                                 (te, teng, tdp.QoS, ttrace)):
        for r in _requests(mod, qos):
            eng.submit(r)
        for _ in range(60):
            if not eng.active and not eng.waiting:
                break
            eng.step()
            trace.append((sorted(eng.active), len(eng.waiting),
                          eng.jet.stats()))
    return je, te, jtrace, ttrace


def test_engines_generate_the_same_tokens(served):
    je, te, _, _ = served
    assert sorted(te.done) == sorted(je.done) == list(range(len(REQUESTS)))
    for rid in je.done:
        assert te.done[rid].generated == je.done[rid].generated
        assert len(te.done[rid].generated) == REQUESTS[rid][1]


def test_engines_admit_and_recycle_lanes_alike(served):
    je, te, jtrace, ttrace = served
    assert ttrace == jtrace
    assert te.jet.stats() == je.jet.stats()
    assert te.jet.stats()["live_transfers"] == 0
    assert {r: te.done[r].lane for r in te.done} == \
        {r: je.done[r].lane for r in je.done}


def test_engine_keeps_lanes_tokens_and_timings(served):
    _, te, _, _ = served
    assert te.tokens.dtype == torch.int32 and te.lengths.dtype == torch.int32
    assert len(te.timings["prefill_s"]) == len(REQUESTS)
    assert all(s > 0 for s in te.timings["decode_s"])


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    tp = {"embed": torch.zeros(4, 4)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.ServingEngine(CFG, teng.EngineConfig(), tp)


def test_engine_backpressure_gates_admission():
    jp = japi.init_params(JCFG, jax.random.key(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    eng = teng.ServingEngine(CFG, teng.EngineConfig(max_lanes=2, max_len=16,
                                                    eos_token=-1),
                             tp, device="cpu")
    eng.set_network_pressure(True)
    eng.submit(teng.Request(0, np.arange(2, 10, dtype=np.int32), 2))
    eng.step()
    assert eng.network_paused and not eng.active and len(eng.waiting) == 1
    eng.set_network_pressure(False)
    eng.run_until_done(max_ticks=10)
    assert len(eng.done[0].generated) == 2


# --------------------------------------------------------------------------- #
# the Jet service copies
# --------------------------------------------------------------------------- #
def _ops(seed, n=200):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 6)), int(rng.integers(0, 3)),
             int(rng.integers(1, 300_000)), float(rng.uniform(0, 3e-3)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jet_service_copy_decides_like_the_reference(seed):
    """Random request / pump / complete / escape / backpressure sequences
    under a small pool leave both services in the same state."""
    out = []
    for jet, qos in ((jjet, jdp.QoS), (tjet, tdp.QoS)):
        cfg = jet.JetConfig(pool_bytes=1 << 20, max_concurrent_transfers=6)
        svc = jet.JetService(cfg)
        for q in qos:
            svc.register(int(q), q)
        now, live, log = 0.0, [], []
        for op, q, nbytes, dt in _ops(seed):
            now += dt
            if op in (0, 1):
                live.append(svc.request(q, nbytes, now))
            elif op == 2:
                log.append([t.xfer_id for t in svc.pump(now)])
            elif op == 3 and live:
                svc.complete(live.pop(q % len(live)), now)
            elif op == 4:
                log.append([a.value for a, _ in svc.tick_escape(now)])
            else:
                svc.set_backpressure(q == 0)
            log.append(svc.stats())
        out.append(log)
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [3, 4])
def test_slab_pool_copy_matches(seed):
    out = []
    for mod in (jpool, tpool):
        pool = mod.SlabPool(256 << 10)
        rng = np.random.default_rng(seed)
        held = {a: [] for a in range(3)}
        log = []
        for step in range(300):
            app, op = int(rng.integers(0, 3)), int(rng.integers(0, 5))
            now = step * 1e-4
            if op <= 1:
                ids = pool.alloc(app, int(rng.integers(1, 40_000)), now)
                held[app].extend(ids or [])
                log.append(ids)
            elif op == 2 and held[app]:
                k = int(rng.integers(1, len(held[app]) + 1))
                pool.free(app, held[app][:k])
                held[app] = held[app][k:]
            elif op == 3:
                log.append(pool.replace(pool.straggler_slots(app, now, 5e-3)))
            else:
                log.append(pool.evict_app(app))
                held[app] = []
            log.append((pool.available_bytes, pool.used_slots,
                        pool.replace_mem_bytes, pool.available_fraction,
                        pool.straggler_ratio(app, now, 5e-3)))
        out.append(log)
    assert out[0] == out[1]


def test_read_window_copy_matches():
    out = []
    for mod in (jwin, twin):
        w = mod.ReadWindow(max_concurrency=4, max_inflight_bytes=1 << 20)
        log = [w.submit_message(700 << 10, 0.0)]
        for i in range(12):
            adm = w.pump(float(i))
            log.append([r.req_id for r in adm])
            if adm:
                w.complete(adm[0].req_id)
            (w.on_ecn if i % 3 == 0 else w.on_quiet)()
            w.check_invariants()
            log.append((w.cap_bytes, w.inflight_bytes, w.deferred))
        out.append(log)
    assert out[0] == out[1]
    assert twin.fragment(600 << 10) == jwin.fragment(600 << 10)


def test_admission_queues_and_escape_copies_match():
    out = []
    for dp, esc, pool_mod in ((jdp, jesc, jpool), (tdp, tesc, tpool)):
        q = dp.AdmissionQueues()
        for i in range(9):
            q.push(i, dp.QoS(i % 3))
        fell = []
        got = q.pump(lambda i: dp.Admit.DEFER if i in (1, 5)
                     else (dp.Admit.STOP if i == 7 else dp.Admit.OK),
                     fell.append)
        pool = pool_mod.SlabPool(64 << 10)
        for app in range(3):
            pool.alloc(app, 20 << 10, 0.0)
        ctl = esc.EscapeController(esc.EscapeConfig(mem_esc_bytes=8 << 10))
        acts = [[a.value for a, _ in ctl.step(pool, t * 1e-3)]
                for t in range(4)]
        out.append((got, fell, len(q), acts, dataclasses.asdict(ctl.stats),
                    [dp.expected_footprint(n, 200.0)
                     for n in (1, 4096, 1 << 20)]))
    assert out[0] == out[1]
