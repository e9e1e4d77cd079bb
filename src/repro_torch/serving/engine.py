"""Batched serving engine with the Jet receive path as admission control
(``repro.serving.engine``).

The mapping (paper §3.2 workflow -> serving): requests are incoming
transfers, admitted by ``JetService`` in QoS-priority order; the decode
lanes are the cache-resident buffer pool, a fixed slab of per-lane state
allocated once and recycled the moment a sequence finishes; the escape
ladder runs once per engine tick.

What differs from the reference, in PyTorch idiom: the lane slab is
updated in place — a prefill's one-sequence state is copied into its
lane's slice (the reference rebuilds the slab with ``.at[].set``) and a
decode step writes its states into the slab (see
:func:`repro_torch.models.decoding.decode_step`); the lane tokens and
lengths stay on the device.  The engine runs on the card unless the
caller asks for the CPU.  As the reference's, it feeds token prompts
only: an architecture that reads image patches or codebook tokens
(llama-3.2-vision-11b, musicgen-large) raises ``ValueError`` at
construction and runs through the model API instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..core.datapath import QoS
from ..core.jet import JetConfig, JetService
from ..models import api as model_api
from ..models.decoding import tree_map


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # [T] token ids
    max_new_tokens: int
    qos: QoS = QoS.NORMAL
    # filled by the engine
    lane: int = -1
    generated: Optional[List[int]] = None
    xfer_id: int = -1


@dataclasses.dataclass
class EngineConfig:
    max_lanes: int = 8           # decode batch slab (the buffer pool)
    max_len: int = 256
    bytes_per_token: int = 4096  # KV bytes/token — Jet admission accounting
    eos_token: int = 1


class ServingEngine:
    """``impl`` goes to the prefill kernels (``"ref"``: their plain
    versions, for comparisons).  ``on_logits(req_ids, logits)``, when
    given, sees the logits rows each greedy token was taken from.
    ``timings`` holds the host seconds of each prefill and each decode
    step, each ending in the read of its tokens (which waits for the
    device)."""

    def __init__(self, cfg: ArchConfig, ectx: EngineConfig, params,
                 jet_cfg: Optional[JetConfig] = None,
                 compute_dtype=torch.float32, device: DeviceLike = None,
                 impl: str = "auto",
                 on_logits: Optional[Callable[[List[int], torch.Tensor],
                                              None]] = None):
        if cfg.num_patches or cfg.num_codebooks:
            what = "image patches" if cfg.num_patches else "codebook tokens"
            raise ValueError(
                f"{cfg.name} reads {what} and the engine feeds token "
                f"prompts only: use the model API (repro_torch.models.api"
                f".prefill(..., patches=...), decode_step, forward)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.ecfg = ectx
        self.params = params
        self.impl = impl
        self.on_logits = on_logits
        self.jet = JetService(jet_cfg or JetConfig())
        for q in QoS:        # one Jet app per service class (paper §3.2)
            self.jet.register(int(q), q)
        self.compute_dtype = compute_dtype
        self.state = model_api.init_decode_state(
            cfg, ectx.max_lanes, ectx.max_len, compute_dtype, self.device)
        self.lengths = torch.zeros((ectx.max_lanes,), dtype=torch.int32,
                                   device=self.device)
        self.tokens = torch.zeros((ectx.max_lanes,), dtype=torch.int32,
                                  device=self.device)
        self.active: Dict[int, Request] = {}     # lane -> request
        self.waiting: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.now = 0.0
        self._jet_admitted: set = set()
        self.timings: Dict[str, List[float]] = {"prefill_s": [],
                                                "decode_s": []}

    # ---- submission (paper step 2) --------------------------------------- #
    def submit(self, req: Request) -> None:
        req.generated = []
        req.xfer_id = self.jet.request(
            int(req.qos), len(req.prompt) * self.ecfg.bytes_per_token,
            self.now)
        self.waiting.append(req)

    def _free_lanes(self) -> List[int]:
        return [i for i in range(self.ecfg.max_lanes)
                if i not in self.active]

    # ---- network feedback (fabric backpressure -> admission) -------------- #
    def set_network_pressure(self, paused: bool) -> None:
        """Gate decode-lane admission on network congestion: while
        asserted no new transfers are admitted to the pool; admitted lanes
        keep decoding."""
        self.jet.set_backpressure(paused)

    @property
    def network_paused(self) -> bool:
        return self.jet.network_paused

    # ---- admission + prefill (paper step 3/4) ----------------------------- #
    def _prefill_into(self, lane: int, req: Request) -> None:
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        logits, state1, _ = model_api.prefill(
            self.params, self.cfg, prompt, max_len=self.ecfg.max_len,
            compute_dtype=self.compute_dtype, impl=self.impl)
        # copy the one-sequence state into the lane's slice of the slab;
        # pattern leaves are [n_units, B, ...], remainder leaves [B, ...]
        tree_map(lambda slab, new: slab[:, lane].copy_(new[:, 0]),
                 self.state["pattern"], state1["pattern"])
        tree_map(lambda slab, new: slab[lane].copy_(new[0]),
                 self.state["remainder"], state1["remainder"])
        self.lengths[lane] = len(req.prompt)
        if self.on_logits is not None:
            self.on_logits([req.req_id], logits)
        tok = int(torch.argmax(logits[0]))
        self.tokens[lane] = tok
        req.generated.append(tok)
        self.timings["prefill_s"].append(time.perf_counter() - t0)

    def _admit(self) -> None:
        # Jet admissions are sticky: a transfer admitted to the pool waits
        # for a free lane (its pool reservation is already held).
        self._jet_admitted |= {t.xfer_id for t in self.jet.pump(self.now)}
        still = []
        for req in self.waiting:
            lanes = self._free_lanes()
            if req.xfer_id in self._jet_admitted and lanes:
                lane = lanes[0]
                req.lane = lane
                self.active[lane] = req
                self._prefill_into(lane, req)
            else:
                still.append(req)
        self.waiting = still

    # ---- one engine tick --------------------------------------------------- #
    def step(self, dt: float = 1e-3) -> None:
        self.now += dt
        self._admit()
        if self.active:
            t0 = time.perf_counter()
            logits, self.state = model_api.decode_step(
                self.params, self.cfg, self.state, self.tokens, self.lengths,
                compute_dtype=self.compute_dtype)
            self.lengths += torch.tensor(
                [1 if i in self.active else 0
                 for i in range(self.ecfg.max_lanes)], dtype=torch.int32,
                device=self.device)
            self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            next_tok = self.tokens.tolist()
            self.timings["decode_s"].append(time.perf_counter() - t0)
            if self.on_logits is not None:
                lanes = sorted(self.active)
                self.on_logits([self.active[i].req_id for i in lanes],
                               logits[lanes])
            finished = []
            for lane, req in self.active.items():
                tok = next_tok[lane]
                req.generated.append(tok)
                if (tok == self.ecfg.eos_token or
                        len(req.generated) >= req.max_new_tokens):
                    finished.append(lane)
            for lane in finished:          # swift recycle of the lane slab
                req = self.active.pop(lane)
                self.jet.complete(req.xfer_id, self.now)
                self.done[req.req_id] = req
        self.jet.tick_escape(self.now)

    def run_until_done(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.active and not self.waiting:
                return
            self.step()
