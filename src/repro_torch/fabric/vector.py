"""Vectorized fabric engine in PyTorch: whole-grid multi-host simulation.

The port of ``repro.fabric.vector``.  Its dense engine: DCQCN, Timely or
HPCC senders, strict-priority or WRR switches, whole-link or per-class
receiver PFC, static ECMP or per-tick dynamic routing (weighted ECMP,
adaptive, spray) under link failure and flap schedules, verbs messages
with a log-histogram of their latencies, and fault injection (lossy
links, corruption, receiver crashes, go-back-N or selective recovery, a
PFC-deadlock watchdog), at a fixed dt.  The entire tick
body is packed into stacked tensors and advances all grid points at
once:

* per-flow DCQCN/offer state as ``[G, F]`` tensors, plus a slot-major
  CNP propagation ring ``[G, Hc, 3, F]``;
* per-port queue state as one ``[G, 2, P, F]`` tensor (axis 1: queued
  bytes, ECN-marked subset) covering every NIC egress queue and switch
  output port on some flow's path (every *candidate* uplink and
  downlink once a point routes dynamically); per-(TC, port) occupancy
  and the PFC assert/pause state ``[G, Q, P]`` come from one-hot
  ``matmul``s with the per-point flow->class one-hot;
* per-receiver datapath state as ``[G, R]`` tensors, the QoS admission
  classes (and the per-class receiver pause state) as ``[G, Q, R]`` and
  the release rings as ``[G, H, 2, R]``;
* routing as per-tick state: the spine choice ``[G, F]``, link up/down
  windows as per-point ``[G, P]`` integer tick bounds, and spray's
  reorder settling as one more slot-major ring ``[G, Hs, 2, F]``;
* the message layer as per-flow started/completed counts ``[G, F]``, a
  message start-time ring ``[G, Lm, F]`` and a ``[G, B, F]`` latency
  histogram; the fault layer as per-flow recovery ledgers ``[G, F]``
  and a counter hash of (tick, link) that decides every drop.

Semantics are the reference's batch-fluid tick, op for op: four
tier-ordered forwarding stages with cut-through inside the tick,
proportional buffer-space allocation and one pre-batch ECN-knee decision
per port per stage, receiver CNPs to the heaviest recently-arriving flow
(lowest flow id on ties), per-flow DCQCN CNP pacing, and per-priority
PFC pause propagation.  The tick's two priority water-fills go through
:mod:`repro_torch.fabric.fused` (CUDA kernels on the card); the WRR
rounds that follow the strict grants are plain tensor code, as in the
reference.

The grid axis is written out (no vmap).  The step takes the simulated
tick ``t`` and the ring iteration ``it`` as Python ints or as 0-d
integer tensors on the device.  On CUDA, :class:`FabricRun` keeps the
state in static buffers and captures a chain of steps, tick counter
included, as a CUDA graph that it replays to the end
(:mod:`repro_torch.fabric.tickgraph`): the counterpart of the
reference's compiled ``lax.scan``.  On the CPU the same static-buffer
chains run without capture; ``graph=False`` runs the eager loop with a
Python tick.  Adaptive dt (:class:`repro_torch.fabric.fused.AdaptiveConfig`)
captures one iteration of the reference's ``lax.while_loop`` body (fine
step, whole-grid stride, macro advance) and replays batches of it,
reading the tick back once a batch.  A built fixed-dt run is re-armed in
place with another packing of its structure (:meth:`FabricRun.load`,
:func:`cached_run`): the sweep farm's chunks replay one captured run.

The sparse-incidence engine (``FabricSweepParams.from_scenarios(...,
sparse=True)``, which ``run_fabric_sweep`` picks for 3-level pod
fabrics) runs the same tick over ``[G, 2, 6, F]`` slot entries: a flow's
bytes at each of up to six tier-ordered hops (NIC egress, leaf uplink,
spine uplink, super-spine, spine downlink, leaf downlink).  Per-(TC,
port) totals are deterministic segment sums at static indices
(:func:`repro_torch.fabric.fused.seg_sum`, a CUDA kernel on the card)
and per-port decisions come back to the flows as gathers, so its cost
grows with flows x hops, not flows x ports.  It takes static ECMP with
failure/flap windows, strict/WRR drain, per-TC switch and host PFC and
the CC zoo; on a 2-tier grid it equals the dense engine.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..core.datapath import N_QOS, hold_us_baseline, hold_us_jet
from ..core.dcqcn import DcqcnConfig
from . import fused
from .cc import CcConfig
from .faults import link_salt, loss_threshold
from .messages import (HIST_BUCKETS, HIST_MIN_US, MSG_COUNT_EPS, hist_ratio,
                       percentile_from_counts)
from .tickgraph import TickChain, adaptive_batches
from .topology import NEVER_TICK

_STAGES = 4          # NIC egress, leaf uplink, spine, leaf downlink
# sparse-incidence stage slots (3-level pod fabrics): NIC egress, leaf
# uplink, spine uplink (-> super-spine), super-spine, spine downlink,
# leaf downlink.  A 2-tier flow leaves slots 2-3 empty.
_STAGES_SP = 6

# pvals entries that stay integer (tick indices, codes, ring offsets)
_INT_KEYS = frozenset(["d_base", "d_strag", "cnp_dly", "fail_at",
                       "fail_until", "rmode", "flet", "settle", "sched",
                       "cc_algo", "f_salt", "f_thr", "f_cthr",
                       "flap_start", "flap_period", "flap_down",
                       "crash_at", "crash_until", "rto_ticks",
                       "nack_ticks", "rto_cap"])

# CcConfig knobs stacked per flow when any point runs a non-DCQCN
# controller (masked `where` lanes select the algorithm per flow)
_CC_SCALARS = [
    ("cc_minr", lambda c: c.min_rate_gbps),
    ("base_rtt", lambda c: c.base_rtt_us),
    ("cc_upd", lambda c: c.update_us),
    ("t_low", lambda c: c.t_low_us),
    ("t_high", lambda c: c.t_high_us),
    ("tl_beta", lambda c: c.timely_beta),
    ("tl_add", lambda c: c.timely_add_gbps),
    ("tl_a", lambda c: c.timely_ewma),
    ("hp_eta", lambda c: c.hpcc_eta),
    ("hp_ai", lambda c: c.hpcc_ai_gbps),
]
_CC_DEFAULT = CcConfig()

_RECV_SCALARS = [
    ("jet", lambda c: 1.0 if c.mode == "jet" else 0.0),
    ("pfc_en", lambda c: 1.0 if c.pfc_enabled else 0.0),
    ("wm_cnp", lambda c: 1.0 if c.rnic_ecn_cnp else 0.0),
    ("line1", lambda c: c.line_rate_gbps),
    ("pcie", lambda c: c.pcie_gbps),
    ("membw", lambda c: c.membw_total_gbps),
    ("cpu_bw", lambda c: c.cpu_membw_gbps),
    ("qp_bytes", lambda c: c.num_qps * c.msg_bytes),
    ("ddio", lambda c: c.ddio_bytes),
    ("knee", lambda c: c.miss_knee),
    ("rnic_buf", lambda c: c.rnic_buffer_bytes),
    ("xoff", lambda c: c.pfc_xoff),
    ("xon", lambda c: c.pfc_xon),
    ("ecn_th", lambda c: c.ecn_threshold),
    ("cnp_iv", lambda c: c.cnp_interval_us),
    ("pool", lambda c: c.jet_pool_bytes),
    ("sfrac", lambda c: c.straggler_frac),
    ("safe", lambda c: c.cache_safe),
    ("danger", lambda c: c.cache_danger),
    ("mem_esc", lambda c: c.mem_esc_bytes),
]

_DCQCN_SCALARS = [
    ("dline", lambda d: d.line_rate_gbps),
    ("minr", lambda d: d.min_rate_gbps),
    ("g", lambda d: d.g),
    ("a_tmr", lambda d: d.alpha_timer_us),
    ("r_tmr", lambda d: d.rate_timer_us),
    ("bctr", lambda d: d.byte_counter_mb * (1 << 20)),
    ("ai", lambda d: d.ai_rate_gbps),
    ("hai", lambda d: d.hai_rate_gbps),
    ("fth", lambda d: float(d.f_threshold)),
]

_SWITCH_SCALARS = [
    ("buf", lambda s: float(s.port_buffer_bytes)),
]

# per-TC switch knobs: resolved to [N_QOS]-vectors per grid point
_SWITCH_TC = [
    ("kmin", lambda s, tc: s.kmin_frac(tc)),
    ("sw_xoff", lambda s, tc: s.xoff_frac(tc)),
    ("sw_xon", lambda s, tc: s.xon_frac(tc)),
]

def _dcqcn_of(s, f, line: float) -> DcqcnConfig:
    """Per-line-rate DCQCN, or the override a DCQCN ``cc`` carries."""
    c = f.cc if getattr(f, "cc", None) is not None \
        else getattr(s.fabric, "cc", None)
    if c is not None and c.algo == "dcqcn" and c.dcqcn is not None:
        return c.dcqcn
    return DcqcnConfig(line_rate_gbps=line)


# --------------------------------------------------------------------------- #
# Packing: scenarios -> static structure + stacked per-point parameters
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class FabricSweepParams:
    """Static fabric structure + stacked per-point parameters (numpy).

    Shapes: F flows, P ports, R receivers, G grid points, H ring horizon.
    """
    # -- static structure (shared by every grid point) ----------------------
    port_keys: List[Tuple[str, str]]     # port id -> out-link key
    recv_hosts: List[str]
    flow_tags: List[str]
    stage_mask: np.ndarray               # [S, P] bool: ports of each stage
    occ: List[np.ndarray]                # S x [P, F]: flow's port per stage
    dest: List[np.ndarray]               # 3 x [P, F]: routing after stage k
    recv_onehot: np.ndarray              # [R, F]
    recv_of: np.ndarray                  # [F] int32
    qos_of: np.ndarray                   # [F] int32: flow's admission class
    prev_onehot: np.ndarray              # [P, F, P]: ingress port of (p, f)
    owner_recv: np.ndarray               # [P] int32: stage-3 port's receiver
    # -- per-point parameters ----------------------------------------------
    pvals: Dict[str, np.ndarray]         # [G], [G, F], [G, R] or [G, P]
    n_points: int
    n_flows: int
    n_ports: int
    n_recv: int
    ticks: int
    dt_us: float
    ring_len: int
    cnp_ring: int                        # CNP propagation ring length
    # hash of the structure arrays, the ring horizons and the capability
    # flags: packings with equal keys (and equal n_points, ticks, rings,
    # dt) run on one built FabricRun (FabricRun.load)
    structure_key: str
    # -- dynamic-routing structure (None on the static path) ----------------
    # With any point routing dynamically (mode != static_ecmp, or a
    # failure or flap schedule), ports cover every candidate uplink and
    # downlink and the spine choice is per-tick state [G, F].
    upP: Optional[np.ndarray] = None     # [S, F, P] candidate uplink 1-hot
    dnP: Optional[np.ndarray] = None     # [S, F, P] candidate downlink
    candS: Optional[np.ndarray] = None   # [S, F] bool candidacy
    crossF: Optional[np.ndarray] = None  # [F] bool: cross-leaf flow
    T1: Optional[np.ndarray] = None      # [P, F, P] uplink->downlink map
    init_spine: Optional[np.ndarray] = None   # [F] int32 (fid % S)
    dyn_route: bool = False
    any_wrr: bool = False                # any point schedules WRR drain
    host_tc: bool = False                # any point runs per-TC host PFC
    settle_ring: int = 1                 # Hs (spray reorder settling)
    n_spines: int = 0
    any_cc: bool = False                 # any point runs a non-DCQCN CC
    any_msg: bool = False                # any point runs the message layer
    msg_ring: int = 1                    # Lm (message start-time ring)
    any_flt: bool = False                # any point attaches a FaultConfig
    any_flap: bool = False               # any point schedules link flaps
    # -- sparse-incidence structure (3-level pod fabrics) --------------------
    # Queue state becomes [G, 2, S, F] slot entries (S = _STAGES_SP):
    # slot (s, f) holds flow f's bytes queued at ``port_of[s, f]``
    # (n_ports = "slot unused").  ``prv_port`` is each slot's ingress
    # port (PFC pause target), ``nxt_slot`` the next occupied slot a
    # stage's drain output enqueues into (_STAGES_SP = "delivered").
    sparse: bool = False
    port_of: Optional[np.ndarray] = None     # [6, F] int32
    prv_port: Optional[np.ndarray] = None    # [6, F] int32
    nxt_slot: Optional[np.ndarray] = None    # [6, F] int32
    pack_fail: bool = False              # sparse grid with failure windows
    # candidate-ingress pauses under failure schedules: a shallow
    # (intra-pod, multi-candidate) flow's last-hop queue also pauses its
    # other candidate downlinks, and every candidate hop joins the
    # pausable ports.  [2, E] (flow, target port) extra pause pairs, and
    # the candidate hop ports.
    pause_extra: Optional[np.ndarray] = None
    pausable_extra: Optional[np.ndarray] = None

    def envelope(self) -> dict:
        """Chunk-boundary envelope of this packing: the capability flags
        and ring horizons a *sub-grid* packing must be floored at to build
        the identical tick (pass to :meth:`from_scenarios` via
        ``envelope=``).  Pack the full grid once, then pack each chunk
        under the full grid's envelope: the chunks then share one
        ``structure_key`` (one built run per chunk shape) and reproduce
        the monolithic run bit for bit."""
        return {"ring_len": self.ring_len, "cnp_ring": self.cnp_ring,
                "settle_ring": self.settle_ring,
                "msg_ring": self.msg_ring,
                "dyn": self.dyn_route or self.pack_fail,
                "wrr": self.any_wrr, "host_tc": self.host_tc,
                "cc": self.any_cc, "msg": self.any_msg,
                "flt": self.any_flt, "flap": self.any_flap}

    @classmethod
    def from_scenarios(cls, scens: Sequence, sparse: bool = False,
                       envelope: Optional[dict] = None
                       ) -> "FabricSweepParams":
        """Pack a grid of scenarios (anything with ``.topology``,
        ``.flows``, ``.fabric``) whose points share the topology
        structure and the flow set; numeric knobs, the routing mode and
        link failure/flap schedules, the message layer, the congestion
        controller and fault injection may vary per point.  A grid with
        no dynamic point keeps the frozen static-ECMP routes, which must
        then agree.

        ``sparse=True`` packs the segmented (slot) incidence instead of
        the dense port x flow one-hots: required for 3-level
        (super-spine) topologies, and it runs any static 2-tier grid.  It
        takes static ECMP with failure/flap windows and the CC zoo; the
        dynamic routing modes, the message layer and fault injection
        raise ``ValueError`` there.

        ``envelope`` (see :meth:`envelope`) floors the capability flags
        and ring horizons at the values of a *larger* grid this packing
        is a chunk of.  The flags and ring lengths are "any / max over the
        grid", so a chunk of a heterogeneous grid would otherwise build a
        different tick than the monolithic run; under the full grid's
        envelope every chunk builds the monolithic grid's tick, which is
        what makes a chunked run bit-identical to the one-run grid."""
        if not scens:
            raise ValueError("empty fabric sweep grid")
        s0 = scens[0]
        topo0, flows0 = s0.topology, s0.flows
        dt = s0.fabric.dt_us
        ticks = int(s0.fabric.sim_time_s * 1e6 / dt)
        F = len(flows0)
        recv_hosts = sorted({f.dst for f in flows0})
        # engine-level capability flags: shared structure, selected per
        # point by plain parameters (rmode / sched / hpfc)
        dyn = any(s.fabric.routing.is_dynamic or bool(s.topology.link_down)
                  or bool(s.topology.link_flaps) for s in scens)
        any_wrr = any(s.fabric.switch.scheduler == "wrr" for s in scens)
        any_flap = any(bool(s.topology.link_flaps) for s in scens)
        host_tc = any(s.fabric.switch.per_tc
                      and s.fabric.receiver_cfg(h).host_pfc_per_tc
                      for s in scens for h in recv_hosts)
        any_flt = any(s.fabric.faults is not None for s in scens)

        # message layer / CC zoo: per-flow Flow overrides falling back to
        # the FabricConfig defaults
        def msg_of(s):
            return [f.msg if f.msg is not None else s.fabric.msg
                    for f in s.flows]

        def cc_of(s):
            return [f.cc if f.cc is not None else s.fabric.cc
                    for f in s.flows]

        any_msg = any(m is not None for s in scens for m in msg_of(s))
        any_cc = any(c is not None and c.algo != "dcqcn"
                     for s in scens for c in cc_of(s))
        # chunk-boundary envelope: floor the capability flags at the
        # enclosing grid's, so every chunk builds the monolithic tick (a
        # chunk with no msg/cc/fault/dynamic point must not build the
        # cheaper structure)
        env = dict(envelope or {})
        dyn = dyn or bool(env.get("dyn"))
        any_wrr = any_wrr or bool(env.get("wrr"))
        any_flt = any_flt or bool(env.get("flt"))
        any_flap = any_flap or bool(env.get("flap"))
        host_tc = host_tc or bool(env.get("host_tc"))
        any_msg = any_msg or bool(env.get("msg"))
        any_cc = any_cc or bool(env.get("cc"))
        pack_fail = False
        if sparse:
            # sparse incidence freezes routes as structure: static ECMP
            # only, with failure/flap windows and the CC zoo as per-point
            # parameters
            if any(s.fabric.routing.is_dynamic for s in scens):
                raise ValueError(
                    "sparse incidence supports static_ecmp routing only; "
                    "dynamic routing modes need the dense engine "
                    "(2-tier topologies)")
            if any_msg:
                raise ValueError("sparse incidence does not support the "
                                 "message layer; use the dense engine")
            if any_flt:
                raise ValueError("sparse incidence does not support "
                                 "FaultConfig injection; use the dense "
                                 "engine")
            pack_fail = dyn         # only failure/flap schedules remain
            dyn = False
        elif any(s.topology.super_spines for s in scens):
            raise ValueError(
                "3-level (super-spine) topologies need the sparse-"
                "incidence engine: run_fabric_sweep(..., "
                "incidence='auto' or 'sparse')")
        if any_msg:
            for s in scens:
                for m in msg_of(s):
                    if m is not None and m.window is None:
                        raise ValueError(
                            "MessageConfig.window=None (unbounded) needs "
                            "a scalar driver; the vector engine carries "
                            "message starts in a fixed ring — set a "
                            "finite window")
        for s in scens:
            s.topology.validate()
            if s.fabric.dt_us != dt or \
                    int(s.fabric.sim_time_s * 1e6 / s.fabric.dt_us) != ticks:
                raise ValueError("grid points must share dt and sim_time")
            if len(s.flows) != F or any(
                    (a.src, a.dst, a.tag, a.qos)
                    != (b.src, b.dst, b.tag, b.qos)
                    for a, b in zip(s.flows, flows0)):
                raise ValueError("grid points must share the flow set "
                                 "(src/dst/tag/qos); offered/burst/start "
                                 "may vary")
        if not dyn:
            # static ECMP: routes are frozen structure and must agree
            routes = [topo0.route(f.src, f.dst, fid)
                      for fid, f in enumerate(flows0)]
            for s in scens:
                if any(s.topology.route(f.src, f.dst, fid) != routes[fid]
                       for fid, f in enumerate(s.flows)):
                    raise ValueError("grid points must share routes (same "
                                     "topology structure)")
        else:
            # routes are per-tick state: only the node/link structure
            # must agree
            for s in scens:
                tt = s.topology
                if (sorted(tt.links) != sorted(topo0.links)
                        or tt.host_leaf != topo0.host_leaf
                        or tt.spines != topo0.spines
                        or tt.leaves != topo0.leaves):
                    raise ValueError(
                        "grid points must share topology structure "
                        "(nodes and links); link rates, failure "
                        "schedules and routing mode may vary")

        # ---- ports on some flow's path, tagged with their stage ---------- #
        port_id: Dict[Tuple[str, str], int] = {}
        port_stage: List[int] = []

        def add(key, stage):
            pid = port_id.setdefault(key, len(port_id))
            if pid == len(port_stage):
                port_stage.append(stage)
            elif port_stage[pid] != stage:
                raise ValueError(f"port {key} used in two stages")
            return pid

        def onehot(idx):                          # [P, F] from [F] ids
            oh = np.zeros((len(port_id), F))
            valid = idx >= 0
            oh[idx[valid], cols[valid]] = 1.0
            return oh

        Sn = len(topo0.spines)
        cols = np.arange(F)
        upP = dnP = candS = crossF = T1 = init_spine = None
        port_of = prv_port = nxt_slot = None
        pause_extra = pausable_extra = None
        if sparse:
            # six tier-ordered stage slots; each flow occupies the slots
            # of its frozen route (2/4/6 hops) and every port belongs to
            # exactly one slot, so per-(port, TC) totals are segment sums
            # over the S*F (slot, flow) entries instead of [P, F] one-hot
            # products: cost grows with flows x hops, not flows x ports
            slot_of = {3: (0, 5), 5: (0, 1, 4, 5), 7: tuple(range(6))}
            stage_ports = np.full((_STAGES_SP, F), -1, np.int64)
            for fid, nodes in enumerate(routes):
                slots = slot_of.get(len(nodes))
                if slots is None:
                    raise ValueError(
                        f"unsupported route length {len(nodes)}")
                for sl_i, hop in zip(slots, zip(nodes, nodes[1:])):
                    stage_ports[sl_i, fid] = add(hop, sl_i)
            # under failure schedules a shallow (intra-pod,
            # multi-candidate) flow's last-hop queue pauses the whole
            # candidate downlink set and every candidate hop joins the
            # pausable ports; deep super-spine routes stay frozen chains
            ex_f, ex_p, cand_ports = [], [], []
            if pack_fail:
                for fid, f in enumerate(flows0):
                    if len(routes[fid]) != 5:
                        continue
                    paths = topo0.candidate_paths(f.src, f.dst)
                    if len(paths) <= 1:
                        continue
                    frozen_dn = stage_ports[4, fid]
                    for pth in paths:
                        pu = add((pth[0], pth[1]), 1)
                        pd = add((pth[1], pth[2]), 4)
                        cand_ports += [pu, pd]
                        if pd != frozen_dn:
                            ex_f.append(fid)
                            ex_p.append(pd)
            if ex_f:
                pause_extra = np.array([ex_f, ex_p], np.int32)
            if cand_ports:
                pausable_extra = np.array(sorted(set(cand_ports)),
                                          np.int32)
            P = len(port_id)
            port_of = np.where(stage_ports >= 0, stage_ports,
                               P).astype(np.int32)
            prv_port = np.full((_STAGES_SP, F), P, np.int32)
            nxt_slot = np.full((_STAGES_SP, F), _STAGES_SP, np.int32)
            for fid in range(F):
                used = np.flatnonzero(stage_ports[:, fid] >= 0)
                for a, b in zip(used, used[1:]):
                    nxt_slot[a, fid] = b
                    prv_port[b, fid] = stage_ports[a, fid]
            occ, dest = [], []
            prev_onehot = np.zeros((0, F, 0))
        elif not dyn:
            stage_ports = np.full((_STAGES, F), -1, np.int32)
            prev_port = np.full((_STAGES, F), -1, np.int32)
            for fid, nodes in enumerate(routes):
                if len(nodes) == 3:                   # intra-leaf
                    src, leaf, dst = nodes
                    p0 = add((src, leaf), 0)
                    p3 = add((leaf, dst), 3)
                    stage_ports[0, fid], stage_ports[3, fid] = p0, p3
                    prev_port[3, fid] = p0
                else:                                 # via one spine
                    src, sl, spine, dl, dst = nodes
                    p0 = add((src, sl), 0)
                    p1 = add((sl, spine), 1)
                    p2 = add((spine, dl), 2)
                    p3 = add((dl, dst), 3)
                    stage_ports[:, fid] = (p0, p1, p2, p3)
                    prev_port[1, fid], prev_port[2, fid], \
                        prev_port[3, fid] = p0, p1, p2
            P = len(port_id)
            occ = [onehot(stage_ports[k]) for k in range(_STAGES)]
            # destination port after stages 0..2 (stage 3 -> receivers)
            d0 = np.where(stage_ports[1] >= 0, stage_ports[1],
                          stage_ports[3])
            dest = [onehot(d0), onehot(stage_ports[2]),
                    onehot(stage_ports[3])]
            prev_onehot = np.zeros((P, F, P))
            for k in range(1, _STAGES):
                for fid in range(F):
                    p, pr = stage_ports[k, fid], prev_port[k, fid]
                    if p >= 0 and pr >= 0:
                        prev_onehot[p, fid, pr] = 1.0
        else:
            # every candidate uplink/downlink joins the port set; the
            # per-tick routing weights decide where bytes go
            hl = topo0.host_leaf
            stage0 = np.full(F, -1, np.int64)
            stage3 = np.full(F, -1, np.int64)
            up_ids = np.full((Sn, F), -1, np.int64)
            dn_ids = np.full((Sn, F), -1, np.int64)
            for fid, f in enumerate(flows0):
                sl, dl = hl[f.src], hl[f.dst]
                if f.src == f.dst:
                    raise ValueError("flow endpoints must differ")
                stage0[fid] = add((f.src, sl), 0)
                if sl == dl:
                    stage3[fid] = add((sl, f.dst), 3)
                else:
                    if not Sn:
                        raise ValueError(f"no spine connects {sl}->{dl}")
                    for si, sp in enumerate(topo0.spines):
                        up_ids[si, fid] = add((sl, sp), 1)
                        dn_ids[si, fid] = add((sp, dl), 2)
                    stage3[fid] = add((dl, f.dst), 3)
            P = len(port_id)
            candS = up_ids >= 0
            crossF = candS.any(0) if Sn else np.zeros(F, bool)
            occ1 = np.zeros((P, F))
            occ2 = np.zeros((P, F))
            upP = np.zeros((Sn, F, P))
            dnP = np.zeros((Sn, F, P))
            T1 = np.zeros((P, F, P))
            prev_onehot = np.zeros((P, F, P))
            for fid in range(F):
                p0, p3 = stage0[fid], stage3[fid]
                if crossF[fid]:
                    for si in range(Sn):
                        pu, pd = up_ids[si, fid], dn_ids[si, fid]
                        occ1[pu, fid] = occ2[pd, fid] = 1.0
                        upP[si, fid, pu] = dnP[si, fid, pd] = 1.0
                        T1[pu, fid, pd] = 1.0
                        prev_onehot[pu, fid, p0] = 1.0
                        prev_onehot[pd, fid, pu] = 1.0
                        # a rerouted or sprayed flow's bytes at the host
                        # port come from any candidate: pause targeting
                        # covers the whole candidate set
                        prev_onehot[p3, fid, pd] = 1.0
                else:
                    prev_onehot[p3, fid, p0] = 1.0
            occ = [onehot(stage0), occ1, occ2, onehot(stage3)]
            # dest[0] covers only intra-leaf flows (cross-leaf stage-0
            # output follows the per-tick weights); the T1 map replaces
            # dest[1]
            dest = [onehot(np.where(crossF, -1, stage3)),
                    np.zeros((P, F)), onehot(stage3)]
            init_spine = np.where(crossF, cols % max(Sn, 1), 0) \
                .astype(np.int32)
        port_keys = list(port_id)

        R = len(recv_hosts)
        ridx = {h: i for i, h in enumerate(recv_hosts)}
        recv_of = np.array([ridx[f.dst] for f in flows0], np.int32)
        qos_of = np.array([int(f.qos) for f in flows0], np.int32)
        n_stages = _STAGES_SP if sparse else _STAGES
        stage_mask = np.zeros((n_stages, P), bool)
        for p, st in enumerate(port_stage):
            stage_mask[st, p] = True
        recv_onehot = np.zeros((R, F))
        recv_onehot[recv_of, cols] = 1.0
        owner_recv = np.full(P, -1, np.int32)
        for (a, b), pid in port_id.items():
            if port_stage[pid] == n_stages - 1:
                owner_recv[pid] = ridx[b]

        # ---- stacked per-point parameters -------------------------------- #
        pv: Dict[str, List] = {k: [] for k in
                               ["gbps", "ecn_en", "can_assert", "line",
                                "cap", "burst", "start", "cnp_iv_f",
                                "d_base", "d_strag", "cnp_dly", "clsF",
                                "on_us", "off_us", "fail_at", "fail_until",
                                "rmode", "flet", "hystb", "settle",
                                "sched", "quanta", "hpfc",
                                "m_bytes", "m_win", "m_extra", "cc_algo",
                                "f_salt", "f_thr", "f_cthr", "f_mtu",
                                "flap_start", "flap_period", "flap_down",
                                "crash_at", "crash_until", "rec_en",
                                "rec_sel", "rto_ticks", "nack_ticks",
                                "rto_cap", "rto_mult"]}
        for name, _ in _RECV_SCALARS + _DCQCN_SCALARS + _SWITCH_SCALARS \
                + _SWITCH_TC + _CC_SCALARS:
            pv[name] = []
        # switch traffic class of each flow as a [Q, F] one-hot; legacy
        # per-link points collapse every flow onto TC 0
        cls_true = np.zeros((N_QOS, F))
        cls_true[[int(f.qos) for f in flows0], np.arange(F)] = 1.0
        cls_legacy = np.zeros((N_QOS, F))
        cls_legacy[0, :] = 1.0
        is_switch = np.array(port_stage) > 0
        for s in scens:
            topo, sw = s.topology, s.fabric.switch
            for name, fn in _SWITCH_SCALARS:
                pv[name].append(fn(sw))
            for name, fn in _SWITCH_TC:
                pv[name].append([fn(sw, tc) for tc in range(N_QOS)])
            pv["clsF"].append(cls_true if sw.per_tc else cls_legacy)
            pv["gbps"].append([topo.links[k].gbps for k in port_keys])
            pv["ecn_en"].append(is_switch * float(sw.ecn_enabled))
            pv["can_assert"].append(is_switch * float(sw.pfc_enabled))
            rcfgs = {h: s.fabric.receiver_cfg(h) for h in recv_hosts}
            for c in rcfgs.values():
                if c.cpu_membw_schedule is not None:
                    raise ValueError("cpu_membw_schedule is not sweepable")
                if c.host_pfc_per_tc and not sw.per_tc:
                    raise ValueError("host_pfc_per_tc requires "
                                     "SwitchConfig.per_tc")
            for name, fn in _RECV_SCALARS:
                pv[name].append([fn(rcfgs[h]) for h in recv_hosts])
            d_b, d_s = [], []
            for h in recv_hosts:
                c = rcfgs[h]
                hold = hold_us_jet(c) if c.mode == "jet" \
                    else hold_us_baseline(c)
                d_b.append(max(1, int(hold / dt)))
                d_s.append(max(1, int(hold * c.straggler_mult / dt)))
            pv["d_base"].append(d_b)
            pv["d_strag"].append(d_s)
            # per-flow NP->RP propagation delay (Flow override, falling
            # back to the FabricConfig scalar)
            pv["cnp_dly"].append([
                max(0, int(round(
                    (f.cnp_delay_us if f.cnp_delay_us is not None
                     else s.fabric.cnp_delay_us) / dt)))
                for f in s.flows])
            if dyn or pack_fail:
                ft = topo.failure_ticks(dt)
                nv = (NEVER_TICK, NEVER_TICK)
                pv["fail_at"].append([ft.get(k, nv)[0] for k in port_keys])
                pv["fail_until"].append([ft.get(k, nv)[1]
                                         for k in port_keys])
            if dyn:
                rc = s.fabric.routing
                pv["rmode"].append(rc.mode_code())
                pv["flet"].append(max(1, int(round(rc.flowlet_gap_us
                                                   / dt))))
                pv["hystb"].append(rc.hysteresis_frac
                                   * sw.port_buffer_bytes)
                stl = int(round(rc.spray_settle_us / dt)) \
                    if rc.mode == "spray" else 0
                pv["settle"].append([stl if crossF[fid] else 0
                                     for fid in range(F)])
            if any_wrr:
                pv["sched"].append(1 if sw.scheduler == "wrr" else 0)
                pv["quanta"].append(list(sw.quanta()))
            if host_tc:
                pv["hpfc"].append([
                    1.0 if (sw.per_tc and rcfgs[h].host_pfc_per_tc)
                    else 0.0 for h in recv_hosts])
            line = [topo.access_gbps(f.src) for f in s.flows]
            pv["line"].append(line)
            msgs, ccs = msg_of(s), cc_of(s)
            # the per-op issue gap is one more rate ceiling (the Mops
            # plateau), folded into the offered cap
            pv["cap"].append([
                min(np.inf if f.offered_gbps is None else f.offered_gbps,
                    np.inf if m is None else m.op_rate_gbps)
                for f, m in zip(s.flows, msgs)])
            if any_msg:
                # m_bytes=inf disables the layer per flow: no message ever
                # starts or completes and the window room is infinite
                pv["m_bytes"].append([np.inf if m is None
                                      else float(m.msg_bytes)
                                      for m in msgs])
                pv["m_win"].append([1.0 if m is None else float(m.window)
                                    for m in msgs])
                pv["m_extra"].append([0.0 if m is None else m.extra_us
                                      for m in msgs])
            if any_cc:
                cl = [c if c is not None else _CC_DEFAULT for c in ccs]
                pv["cc_algo"].append([c.code() for c in cl])
                for name, fn in _CC_SCALARS:
                    pv[name].append([fn(c) for c in cl])
            pv["burst"].append([np.inf if f.burst_bytes is None
                                else f.burst_bytes for f in s.flows])
            pv["start"].append([f.start_us for f in s.flows])
            pv["on_us"].append([np.inf if f.on_off_us is None
                                else f.on_off_us[0] for f in s.flows])
            pv["off_us"].append([0.0 if f.on_off_us is None
                                 else f.on_off_us[1] for f in s.flows])
            pv["cnp_iv_f"].append([rcfgs[f.dst].cnp_interval_us
                                   for f in s.flows])
            dcq = [_dcqcn_of(s, f, lr) for f, lr in zip(s.flows, line)]
            for name, fn in _DCQCN_SCALARS:
                pv[name].append([fn(d) for d in dcq])
            if any_flt:
                _pack_faults(pv, s.fabric.faults, port_keys, ridx, msgs,
                             dt, P, R)
            if any_flap:
                fl = topo.flap_ticks(dt)
                nf = (NEVER_TICK, 2, 1)
                pv["flap_start"].append([fl.get(k, nf)[0]
                                         for k in port_keys])
                pv["flap_period"].append([fl.get(k, nf)[1]
                                          for k in port_keys])
                pv["flap_down"].append([fl.get(k, nf)[2]
                                        for k in port_keys])
        pvals = {k: np.asarray(v, np.int32 if k in _INT_KEYS
                               else np.float64)
                 for k, v in pv.items() if v}
        H = int(max(pvals["d_base"].max(), pvals["d_strag"].max())) + 2
        Hc = int(pvals["cnp_dly"].max()) + 1
        Hs = int(pvals["settle"].max()) + 1 if dyn else 1
        # message start-time ring: the window bound keeps outstanding
        # <= W+1; +4 leaves slack for float32 count jitter at boundaries
        Lm = int(pvals["m_win"].max()) + 4 if any_msg else 1
        # chunk-boundary envelope: ring horizons are grid maxima, so a
        # chunk's rings are floored at the enclosing grid's (a longer
        # ring is inert: unread slots hold zeros)
        H = max(H, int(env.get("ring_len", 0)))
        Hc = max(Hc, int(env.get("cnp_ring", 0)))
        if dyn:
            Hs = max(Hs, int(env.get("settle_ring", 0)))
        if any_msg:
            Lm = max(Lm, int(env.get("msg_ring", 0)))
        # the reference's hash, byte for byte: equal structure arrays and
        # flags give the reference's key
        h = hashlib.sha1()
        extras = [a for a in (upP, dnP, candS, crossF, T1, init_spine,
                              port_of, prv_port, nxt_slot,
                              pause_extra, pausable_extra)
                  if a is not None]
        for arr in (stage_mask, *occ, *dest, recv_onehot, recv_of, qos_of,
                    prev_onehot, owner_recv, *extras):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr((F, P, R, ticks, dt, H, Hc, Hs, Sn, dyn, any_wrr,
                       host_tc, any_cc, any_msg, Lm, any_flt,
                       any_flap, sparse, pack_fail)).encode())
        return cls(port_keys=port_keys, recv_hosts=recv_hosts,
                   flow_tags=[f.tag for f in flows0],
                   stage_mask=stage_mask, occ=occ, dest=dest,
                   recv_onehot=recv_onehot, recv_of=recv_of, qos_of=qos_of,
                   prev_onehot=prev_onehot, owner_recv=owner_recv,
                   pvals=pvals, n_points=len(scens), n_flows=F, n_ports=P,
                   n_recv=R, ticks=ticks, dt_us=dt, ring_len=H,
                   cnp_ring=Hc, structure_key=h.hexdigest(), upP=upP,
                   dnP=dnP, candS=candS, crossF=crossF, T1=T1,
                   init_spine=init_spine,
                   dyn_route=dyn, any_wrr=any_wrr, host_tc=host_tc,
                   settle_ring=Hs, n_spines=Sn if dyn else 0,
                   any_cc=any_cc, any_msg=any_msg, msg_ring=Lm,
                   any_flt=any_flt, any_flap=any_flap,
                   sparse=sparse, port_of=port_of, prv_port=prv_port,
                   nxt_slot=nxt_slot, pack_fail=pack_fail,
                   pause_extra=pause_extra, pausable_extra=pausable_extra)

    @classmethod
    def from_arrays(cls, d: Dict) -> "FabricSweepParams":
        """Build the packing from the reference's (``repro``'s
        ``FabricSweepParams`` as a field -> value dict of numpy arrays and
        Python scalars), dense or sparse, so both engines can run on
        identical packed parameters.  Raises if the packing lacks a field
        or carries one it does not know."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in d]
        if missing:
            raise ValueError(f"packing lacks {missing}")
        unknown = [k for k in d if k not in names]
        if unknown:
            raise ValueError(f"unknown packing field {unknown[0]!r}")
        return cls(**{n: d[n] for n in names})


def _pack_faults(pv, ff, port_keys, ridx, msgs, dt: float, P: int,
                 R: int) -> None:
    """Append one point's fault-layer parameters: per-port hash salts and
    thresholds, crash windows per receiver, per-flow recovery knobs.  A
    ``faults=None`` point packs never-firing values and ``mtu=inf``, so
    its ``dropped_pkts`` stays exactly 0."""
    if ff is None:
        pv["f_salt"].append([0] * P)
        pv["f_thr"].append([0] * P)
        pv["f_cthr"].append([0] * P)
        pv["crash_at"].append([NEVER_TICK] * R)
        pv["crash_until"].append([NEVER_TICK] * R)
        pv["f_mtu"].append(np.inf)
    else:
        pv["f_salt"].append([link_salt(a, b, ff.seed) for a, b in port_keys])
        pv["f_thr"].append([loss_threshold(ff.rate_for(a, b))
                            for a, b in port_keys])
        # corruption (CRC fail) only on receiver access links
        pv["f_cthr"].append([loss_threshold(ff.corrupt_rate) if b in ridx
                             else 0 for a, b in port_keys])
        ca, cu = [NEVER_TICK] * R, [NEVER_TICK] * R
        for ch, (a_us, r_us) in ff.crashes.items():
            if ch not in ridx:
                raise ValueError(f"crash scheduled on {ch!r}, which is not "
                                 "a receiver in this fabric")
            at = max(0, int(round(a_us / dt)))
            ca[ridx[ch]] = at
            cu[ridx[ch]] = max(at + 1, int(round(r_us / dt)))
        pv["crash_at"].append(ca)
        pv["crash_until"].append(cu)
        pv["f_mtu"].append(ff.mtu_bytes)
    # recovery ledgers engage per flow iff a FaultConfig is attached and
    # the flow carries a MessageConfig
    pv["rec_en"].append([1.0 if (ff is not None and m is not None) else 0.0
                         for m in msgs])
    pv["rec_sel"].append([1.0 if (m is not None
                                  and m.recovery == "selective") else 0.0
                          for m in msgs])
    pv["rto_ticks"].append([1 if m is None
                            else max(1, int(round(m.rto_us / dt)))
                            for m in msgs])
    pv["nack_ticks"].append([1 if m is None
                             else max(1, int(round(m.nack_us / dt)))
                             for m in msgs])
    pv["rto_cap"].append([0 if m is None else int(m.rto_cap) for m in msgs])
    pv["rto_mult"].append([1.0 if m is None else float(m.rto_backoff)
                           for m in msgs])


# --------------------------------------------------------------------------- #
# Host-side preparation
# --------------------------------------------------------------------------- #
def _np_params(fsp: FabricSweepParams, dtype) -> Dict[str, np.ndarray]:
    p = {k: (v if v.dtype == np.int32 else v.astype(dtype))
         for k, v in fsp.pvals.items()}
    # closed-flow completion threshold (fabric.burst_done_bytes)
    burst = fsp.pvals["burst"]
    p["burst_done"] = np.where(
        np.isfinite(burst),
        burst - np.maximum(1e-6, 1e-4 * np.where(np.isfinite(burst),
                                                 burst, 0.0)),
        np.inf).astype(dtype)
    p["d2"] = np.stack([p.pop("d_base"), p.pop("d_strag")], -2)
    return p


def _static(fsp: FabricSweepParams) -> Dict[str, object]:
    """Static structure arrays (numpy, float64 / int / bool)."""
    P, F = fsp.n_ports, fsp.n_flows
    owner = fsp.owner_recv
    cls_onehot = np.zeros((N_QOS, F))
    cls_onehot[fsp.qos_of, np.arange(F)] = 1.0
    out = {
        "cls_of": fsp.qos_of,
        "cls_recv": cls_onehot[:, None, :] * fsp.recv_onehot[None, :, :],
        "stage": fsp.stage_mask,
        "recv_onehot": fsp.recv_onehot,
        "recv_of": fsp.recv_of,
        "owner_clamp": np.maximum(owner, 0),
        "owner_valid": owner >= 0,
    }
    if fsp.sparse:
        S = _STAGES_SP
        sel_inj = np.zeros((2, S, 1))
        sel_inj[0, 0, 0] = 1.0
        selm = np.zeros((2, 1))
        selm[1, 0] = 1.0
        out.update({
            # where stage k's drain output enqueues: [S, F] one-hot of
            # each flow's next slot (none past its last)
            "nxt_oh": [(fsp.nxt_slot[k][None, :] == np.arange(S)[:, None])
                       .astype(np.float64) for k in range(S - 1)],
            "row_oh": [np.eye(S)[k][:, None] for k in range(S)],
            "sel_inj": sel_inj,
            "selm": selm,
        })
        if fsp.pause_extra is not None:
            out["ex_f"] = fsp.pause_extra[0]
        return out
    sel = np.zeros((2, 2, 1, 1))
    sel[0, 0], sel[1, 1] = 1.0, 1.0
    return {
        **out,
        "occ": list(fsp.occ),
        "dest": list(fsp.dest),
        "prev_mat": fsp.prev_onehot.reshape(P * F, P),
        "sel0": sel[0],
        "sel1": sel[1],
        **({"upP": fsp.upP, "dnP": fsp.dnP, "candS": fsp.candS,
            "T1": fsp.T1} if fsp.dyn_route else {}),
        # deadlock-watchdog scatter: port -> flattened (u, v) node pair
        **({"dl_E": fused.pause_pair_onehot(fsp.port_keys)}
           if fsp.any_flt else {}),
    }


def _seg_plans(fsp: FabricSweepParams, device) -> Dict[str, object]:
    """The sparse tick's segment-sum plans, one per static index, built
    once (:func:`repro_torch.fabric.fused.seg_plan`).  Bins are the flat
    ``tc * (P + 1) + port`` addresses (column P is the "slot unused"
    dummy) or the padded ports; each plan's ``idx`` also serves the
    gathers that read a per-(TC, port) value back to the flows."""
    S, P, F = _STAGES_SP, fsp.n_ports, fsp.n_flows
    Ppad = P + 1
    QPpad = N_QOS * Ppad
    po = fsp.port_of.astype(np.int64)                     # [S, F]
    qos = fsp.qos_of.astype(np.int64)                     # [F]
    qp = qos[None, :] * Ppad + po
    pp = qos[None, :] * Ppad + fsp.prv_port.astype(np.int64)
    cols = np.arange(F)
    dq = []
    for k in range(S - 1):
        nx = fsp.nxt_slot[k].astype(np.int64)
        tp = np.where(nx < S, po[np.minimum(nx, S - 1), cols], P)
        dq.append(qos * Ppad + tp)

    def plan(idx, size):
        return fused.seg_plan(idx, size, device)
    out = {"qp_k": [plan(qp[k], QPpad) for k in range(S)],
           "qp_flat": plan(qp.reshape(-1), QPpad),
           "pp_flat": plan(pp.reshape(-1), QPpad),
           "dq_k": [plan(d, QPpad) for d in dq],
           "po_k": [plan(po[k], Ppad) for k in range(S)],
           "po_flat": plan(po.reshape(-1), Ppad)}
    if fsp.pause_extra is not None:
        exf = fsp.pause_extra[0].astype(np.int64)
        out["ex_flat"] = plan(qos[exf] * Ppad
                              + fsp.pause_extra[1].astype(np.int64), QPpad)
    return out


def _to_device(a, dtype: torch.dtype, device: torch.device):
    """numpy -> torch on ``device``: floats in the engine dtype, bools as
    bool, integers as int64 (index tensors for gathers)."""
    if isinstance(a, list):
        return [_to_device(x, dtype, device) for x in a]
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _init_state(fsp: FabricSweepParams, p, dtype, device):
    """Zero/steady-state carry, every tensor with the leading grid axis."""
    G, F, P, R = fsp.n_points, fsp.n_flows, fsp.n_ports, fsp.n_recv
    H, Hc = fsp.ring_len, fsp.cnp_ring

    def z(*sh):
        return torch.zeros((G,) + sh, dtype=dtype, device=device)

    def full(v, *sh, dt=dtype):
        return torch.full((G,) + sh, v, dtype=dt, device=device)

    def flags(*sh):
        return torch.zeros((G,) + sh, dtype=torch.bool, device=device)

    s = {
        # flows
        "rc": p["dline"] + z(F), "rt": p["dline"] + z(F),
        "alpha": full(1.0, F),
        "t_us": z(F), "byts": z(F), "t_stage": z(F), "b_stage": z(F),
        "a_tus": z(F), "injected": z(F), "delivered": z(F),
        "inj_lo": z(F), "deliv_lo": z(F),
        "completion": full(float("inf"), F),
        "backlog": z(F),
        # immediate first paced CNP, as in the scalar driver
        "pace_tus": full(float("inf"), F),
        # CNP propagation ring (slot-major, 3 notification sources)
        "cring": z(Hc, 3, F),
        # ports (axis 1: 0 = queued bytes, 1 = ECN-marked subset); a
        # sparse grid queues per (stage slot, flow) instead of (port,
        # flow), its PFC state stays classed [Q, P]
        "qm": z(2, _STAGES_SP if fsp.sparse else P, F),
        "asserted": flags(N_QOS, P),
        "paused": flags(N_QOS, P),
        "pause_us": z(P),
        "pause_tc_us": z(N_QOS, P),
        "ever_paused": flags(P),
        # receivers ("qos_q" = HostDatapath's per-class RNIC buffer)
        "qos_q": z(N_QOS, R), "resident": z(R), "strag_res": z(R),
        "esc_debt": z(R), "repl_debt": z(R), "repl_mem": z(R),
        "rnic_drop": z(R), "drained": z(R), "nic_dram": z(R),
        "mem_fb": z(R),
        "esc_dram": z(R), "miss_sum": z(R), "pool_sum": z(R),
        "pool_peak": z(R), "cnps": z(R), "ecns": z(R), "replaces": z(R),
        "copies": z(R), "pfc_us": z(R), "ecn_tus": z(R),
        "cnp_tus": p["cnp_iv"] + z(R),   # allow an immediate first CNP
        # per-class pause state when any point runs per-TC host PFC
        # (legacy points keep every row in lockstep)
        "pfc": flags(N_QOS, R) if fsp.host_tc else flags(R),
        "ring": z(H, 2, R),     # slot-major; axis 2: base / straggler
        "heavy": full(-1, R, dt=torch.int32),
        # fleet counters
        "ecn_marked": z(), "sw_dropped": z(),
    }
    if fsp.sparse:
        # per-uplink carried bytes (the fabric uplinks' utilization)
        s["tx"] = z(P)
    if fsp.dyn_route:
        # routing state: current spine choice (static hash seed), reroute
        # counts and per-port carried bytes
        s["route"] = torch.as_tensor(fsp.init_spine, dtype=torch.int32,
                                     device=device).expand(G, F).clone()
        s["reroutes"] = z(F)
        s["tx"] = z(P)
        if fsp.n_spines:
            # idle-gap flowlets: per-flow flowlet index and last active
            # tick (far past, so the first injection opens a flowlet)
            s["flet_k"] = full(0, F, dt=torch.int32)
            s["flet_last"] = full(-(1 << 30), F, dt=torch.int32)
    if fsp.settle_ring > 1:
        s["sring"] = z(fsp.settle_ring, 2, F)
    if fsp.any_cc:
        # delay/INT controller state (TimelyRate / HpccRate)
        s["prev_rtt"] = p["base_rtt"] + z(F)
        s["rtt_diff"] = z(F)
        s["cc_tus"] = z(F)
    if fsp.any_msg:
        # message layer: started/completed counts, start-time ring,
        # latency sum and the fixed-bucket log histogram
        s["m_hw"] = full(0, F, dt=torch.int64)
        s["m_done"] = full(0, F, dt=torch.int64)
        s["mring"] = z(fsp.msg_ring, F)
        s["m_lat"] = z(F)
        s["m_last"] = z(F)
        s["m_hist"] = z(HIST_BUCKETS, F)
        s["m_over"] = z(F)
    if fsp.any_flt:
        # fault layer: the per-flow recovery ledger (lost bytes, RTO timer
        # and backoff stage, go-back-N gap flag), retransmit and fault-drop
        # accumulators, crash-recovery stamps and the switch-side
        # link-pause mask (crash rebuilds)
        s["lost"] = z(F)
        s["rto_t"] = full(0, F, dt=torch.int64)
        s["rto_k"] = full(0, F, dt=torch.int64)
        s["gapped"] = flags(F)
        s["retx"] = z(F)
        s["flt_drop"] = z()
        s["crash_rec"] = full(float("inf"), R)
        s["lpause"] = flags(N_QOS, P)
        s["deadlock"] = z()
    return s


# --------------------------------------------------------------------------- #
# Link state and spine choice of one tick, stacked: Topology.link_up_at
# and the routing.* helpers of the scalar engine over [G, P] and
# [G, S, F] tensors (the tests hold each to its scalar twin)
# --------------------------------------------------------------------------- #
def link_state(t, p, flap: bool):
    """Down and falling-edge masks ``[G, P]`` at tick ``t`` (a Python int
    or a 0-d integer tensor) from the
    per-point failure windows (down while ``fail_at <= t < fail_until``)
    and, with ``flap``, the periodic flaps folded into the same masks:
    down for the first ``flap_down`` ticks of each ``flap_period`` from
    ``flap_start`` (the negative phase before the start is masked)."""
    downP = (t >= p["fail_at"]) & (t < p["fail_until"])
    edgeP = p["fail_at"] == t
    if flap:
        live = t >= p["flap_start"]
        phase = (t - p["flap_start"]) % p["flap_period"]
        downP = downP | (live & (phase < p["flap_down"]))
        edgeP = edgeP | (live & (phase == 0))
    return downP, edgeP


def flowlet_hashes(fid, k, scale):
    """``routing.flowlet_hash`` of int32 flow ids ``fid`` [F] and flowlet
    indices ``k`` [G, F] in ``scale``'s dtype (``scale`` = 65536); ``k``
    reduced mod 2^16 keeps every product inside int32."""
    kred = k % 65536
    hv = ((fid + 1) * 40503 + kred * 9973) % 65536
    return hv.to(scale.dtype) / scale


def adaptive_choice(occS, upS, cur, cur_oh, up_cur, hyst, one, zero, inf):
    """``routing.adaptive_pick`` for every (point, flow): the
    least-congested up candidate (first minimum) of ``occS`` [G, S, F],
    taken only when the current spine ``cur`` [G, F] is down or that
    candidate's queue is more than ``hyst`` shorter; ``cur`` when every
    candidate is down."""
    occ_cur = (occS * torch.where(cur_oh, one, zero)).sum(-2)
    occ_masked = torch.where(upS, occS, inf)
    best = torch.argmin(occ_masked, -2).to(torch.int32)
    occ_best = occ_masked.amin(-2)
    return torch.where(
        upS.any(-2) & (~up_cur | (occ_best < occ_cur - hyst)), best, cur)


def weighted_choice(free, hsh, one, zero):
    """``routing.weighted_pick`` of weights ``free`` [G, S, F] at hashes
    ``hsh`` [G, F]: the first spine whose cumulative weight exceeds
    ``hsh`` times the cumsum's own last element (which the sequential
    sum always reaches).  Returns the pick and that total [G, F]; the
    pick is meaningful where the total is positive."""
    cum = torch.cumsum(free, -2)
    tot = cum[:, -1]
    over = torch.where(cum > (hsh * tot)[:, None, :], one, zero)
    return torch.argmax(over, -2).to(torch.int32), tot


def spray_split(free, tot, ch_oh, zero, tiny):
    """``routing.spray_weights``: the byte split [G, S, F] in proportion
    to free space ``free`` over its total ``tot`` [G, F], or the chosen
    spine's one-hot ``ch_oh`` where nothing is up or has room."""
    totS = tot[:, None, :]
    return torch.where(totS > zero, free / torch.maximum(totS, tiny),
                       ch_oh)


def fault_saltp(f_salt):
    """The salt term ``(salt + 1) * 9973 % 65536`` of the counter hashes
    (``faults.fault_hash`` / ``corrupt_hash``), for integer salts."""
    return (f_salt + 1) * 9973 % 65536


def fault_drops(t, saltp, thr, cthr):
    """Drop mask ``[G, P]`` at tick ``t`` (a Python int or a 0-d integer
    tensor): the loss hash under ``thr`` or
    the corruption hash under ``cthr`` (integer tensors).  The tick
    multipliers are applied as a split modmul: ``(t+1) % 65536`` split
    into high and low bytes, with 256*40503 % 65536 = 14080 and
    256*24593 % 65536 = 4352, so no product passes 6.6e8 and the values
    equal ``fault_hash`` / ``corrupt_hash`` at any tick."""
    tr = (t + 1) % 65536
    thi, tlo = tr // 256, tr % 256
    hl = (saltp + (thi * 14080 + tlo * 40503)) % 65536
    hc = (saltp + (thi * 4352 + tlo * 24593)) % 65536
    return (hl < thr) | (hc < cthr)


def _slot_write(ring, slot, v):
    """``ring[:, slot] = v`` for a Python-int slot, or for a 0-d index
    tensor on the ring's device (``index_copy_``, which reads the slot on
    the device)."""
    if isinstance(slot, int):
        ring[:, slot] = v
    else:
        ring.index_copy_(1, slot.reshape(1), v.unsqueeze(1))


# --------------------------------------------------------------------------- #
# The per-tick step
# --------------------------------------------------------------------------- #
def _hoist(p, opts: dict, dt: float, dtype: torch.dtype,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """The per-point constants the tick reads, computed once from the
    parameters ``p`` (``[G, ...]`` tensors): budgets, thresholds, masks
    and the CC, message and fault lanes' constants.  Some entries are
    views of ``p``.  :func:`_make_step` builds the tick over these
    tensors and :meth:`FabricRun.load` recomputes them into the same
    storage, which a captured graph reads by address."""
    def c(x):
        return torch.tensor(x, dtype=dtype, device=device)

    bpt = c(1e9 / 8.0 * dt * 1e-6)       # bytes per (Gbps * tick)
    zero, one, half = c(0.0), c(1.0), c(0.5)
    h = {}
    h["budget"] = p["gbps"] * bpt
    h["budget_crumb"] = h["budget"] * c(1e-6)
    h["clsF"] = p["clsF"]                              # [G, Q, F]
    h["buf_tc"] = p["buf"][:, None, None]
    h["kmin_th"] = p["kmin"][..., None] * h["buf_tc"]
    h["ecn_on"] = p["ecn_en"] > 0.5
    h["can_assert"] = p["can_assert"] > 0.5
    h["sxoff"] = p["sw_xoff"][..., None]
    h["sxon"] = p["sw_xon"][..., None]
    h["onoff"] = p["off_us"] > zero
    h["period"] = torch.where(h["onoff"], p["on_us"] + p["off_us"], one)
    h["jet"] = p["jet"] > 0.5
    h["avail_dram"] = torch.maximum(zero, p["membw"] - p["cpu_bw"])
    h["jet_cap"] = torch.minimum(p["pcie"], p["line1"] * 4.0) * bpt
    h["strag_share"] = torch.where(h["jet"], p["sfrac"], zero)
    h["inv_knee"] = one / (p["knee"] * p["ddio"])
    h["rx_pfc_en"] = p["pfc_en"] > 0.5
    h["wm_en"] = p["wm_cnp"] > 0.5
    h["linecap"] = torch.minimum(p["line"], p["cap"])
    if opts["wrr"]:
        h["quantaQ"] = p["quanta"][..., None]            # [G, Q, 1]
        h["is_wrr"] = (p["sched"] == 1)[:, None, None]   # [G, 1, 1]
    if opts["host_tc"]:
        h["hpfc_b"] = (p["hpfc"] > half)[:, None, :]     # [G, 1, R]
        h["rx_pfc_tc"] = h["rx_pfc_en"][:, None, :]
        h["xoffQ"] = p["xoff"][:, None, :]
        h["xonQ"] = p["xon"][:, None, :]
        # each admission class's 1/N_QOS share of the RNIC buffer
        h["part_q"] = (p["rnic_buf"] / c(float(N_QOS)))[:, None, :]
    if opts["dyn"] and opts["Sn"]:
        h["bufSF"] = p["buf"][:, None, None]             # vs [G, S, F]
        h["hystF"] = p["hystb"][:, None]                 # vs [G, F]
        h["rmode"] = p["rmode"][:, None]                 # [G, 1]
        h["is_spray"] = (h["rmode"] == 3)[..., None]     # [G, 1, 1]
    if opts["cc"]:
        # algorithm lanes (CcConfig.code: 0 dcqcn, 1 timely, 2 hpcc)
        h["is_dcqcn"] = p["cc_algo"] == 0
        h["timely_m"] = p["cc_algo"] == 1
        h["hpcc_m"] = p["cc_algo"] == 2
        h["inv_brtt"] = one / p["base_rtt"]              # [G, F]
    if opts["msg"]:
        h["wbytes"] = p["m_win"] * p["m_bytes"]          # window, in bytes
    if opts["flt"]:
        # fault layer (repro_torch.fabric.faults): per-flow recovery masks
        # and the per-port counter-hash salts (see fault_drops)
        h["rec_en"] = p["rec_en"]                        # exact 1.0 / 0.0
        h["rec_keep"] = one - h["rec_en"]
        h["sel_b"] = p["rec_sel"] > half
        h["gbn_b"] = (h["rec_en"] > half) & ~h["sel_b"]
        h["saltp"] = fault_saltp(p["f_salt"])            # [G, P]
        h["rto_f"] = p["rto_ticks"].to(dtype)
    if opts["sparse"]:
        # padded per-port budget for the telemetry gathers (budget 0 at
        # the dummy column: the leg drops out)
        h["budget_pad"] = torch.cat(
            [h["budget"], torch.zeros_like(h["budget"][:, :1])], -1)
    return h


def _make_step(st, p, hp, dt: float, H: int, Hc: int, ticks: int,
               dtype: torch.dtype, device: torch.device, impl: str,
               opts: dict):
    """Build ``step(state, t, it=None) -> state`` over ``[G, ...]``
    tensors.

    ``st`` holds the static structure tensors (no grid axis), ``p`` the
    per-point parameters ``[G, ...]`` and ``hp`` the per-point constants
    hoisted out of the tick (:func:`_hoist`), all on ``device``.  Queued
    bytes and their ECN-marked subset travel together as one ``[G, 2, P,
    F]`` tensor and the two release rings as one ``[G, H, 2, R]`` tensor.
    ``opts`` holds the packing's capability flags (see :func:`_opts`);
    with all of them off the step is the static engine's.  Integer
    quantities (tick windows, fault hashes, message counts, retransmit
    timers) stay integer tensors with floor ``%`` and ``//``.
    """
    dyn, wrr, host_tc = opts["dyn"], opts["wrr"], opts["host_tc"]
    Hs, Sn, flap = opts["Hs"], opts["Sn"], opts["flap"]
    any_cc, any_msg, Lm, flt = opts["cc"], opts["msg"], opts["Lm"], \
        opts["flt"]
    sparse = opts["sparse"]
    links = dyn or opts["fail"]          # per-tick link up/down state

    def c(x):                            # 0-d constant of the engine dtype
        return torch.tensor(x, dtype=dtype, device=device)

    bpt = c(1e9 / 8.0 * dt * 1e-6)       # bytes per (Gbps * tick)
    fdt = c(dt)
    zero, one, tiny = c(0.0), c(1.0), c(1e-30)
    half, inf = c(0.5), c(float("inf"))
    eps_q = c(1e-9)
    fold_at = c(65536.0)
    # simulated end-of-tick time of every tick, (t + 1) * dt in the
    # engine dtype, indexed by the tick
    nows = (torch.arange(ticks, device=device).to(dtype) + one) * fdt
    F = st["recv_of"].shape[0]
    arangeF = torch.arange(F, dtype=torch.int32, device=device)
    cls_of, recv_of = st["cls_of"], st["recv_of"]
    occ, dest = st.get("occ"), st.get("dest")
    # loop-invariant per-point quantities (_hoist)
    budget, budget_crumb, clsF = hp["budget"], hp["budget_crumb"], \
        hp["clsF"]
    buf_tc, kmin_th, ecn_on = hp["buf_tc"], hp["kmin_th"], hp["ecn_on"]
    can_assert, sxoff, sxon = hp["can_assert"], hp["sxoff"], hp["sxon"]
    onoff, period, jet = hp["onoff"], hp["period"], hp["jet"]
    avail_dram, jet_cap = hp["avail_dram"], hp["jet_cap"]
    strag_share, inv_knee = hp["strag_share"], hp["inv_knee"]
    rx_pfc_en, wm_en, linecap = hp["rx_pfc_en"], hp["wm_en"], \
        hp["linecap"]
    if wrr:
        quantaQ, is_wrr = hp["quantaQ"], hp["is_wrr"]
    if host_tc:
        hpfc_b, rx_pfc_tc = hp["hpfc_b"], hp["rx_pfc_tc"]
        xoffQ, xonQ, part_q = hp["xoffQ"], hp["xonQ"], hp["part_q"]
    if dyn and Sn:
        bufSF, hystF = hp["bufSF"], hp["hystF"]
        rmode, is_spray = hp["rmode"], hp["is_spray"]
        arangeS = torch.arange(Sn, dtype=torch.int32,
                               device=device)[:, None]   # [S, 1]
        flet_scale = c(65536.0)                          # flowlet hash
    if any_cc:
        is_dcqcn, timely_m, hpcc_m = hp["is_dcqcn"], hp["timely_m"], \
            hp["hpcc_m"]
        inv_brtt = hp["inv_brtt"]
        u_floor, two = c(0.01), c(2.0)
    if any_msg:
        arangeL = torch.arange(Lm, device=device)[:, None]            # [L, 1]
        arangeB = torch.arange(HIST_BUCKETS, device=device)[:, None, None]
        hist_lo = c(HIST_MIN_US)
        inv_lr = c(1.0 / np.log(hist_ratio()))
        eps_m = c(MSG_COUNT_EPS)
        wbytes = hp["wbytes"]
    if flt:
        rec_en, rec_keep = hp["rec_en"], hp["rec_keep"]
        sel_b, gbn_b = hp["sel_b"], hp["gbn_b"]
        saltp, rto_f = hp["saltp"], hp["rto_f"]
        n_dl = int(round(float(np.sqrt(st["dl_E"].shape[-1]))))

        def ledger(s, lost_f):
            """Route per-flow lost bytes [G, F]: the fluid core's instant
            re-credit, or the recovery ledger where engaged; go-back-N
            losses gap the receiver window."""
            s["inj_lo"] = s["inj_lo"] - lost_f * rec_keep
            s["lost"] = s["lost"] + lost_f * rec_en
            s["gapped"] = s["gapped"] | (gbn_b & (lost_f > zero))

    def qsum(x):
        """Sum over the class axis of [G, Q, N] in class order."""
        acc = x[:, 0]
        for q_i in range(1, x.shape[1]):
            acc = acc + x[:, q_i]
        return acc

    def cut(s, fire):
        """DCQCN on_cnp for flows where ``fire`` holds."""
        s["rt"] = torch.where(fire, s["rc"], s["rt"])
        s["rc"] = torch.where(
            fire, torch.maximum(p["minr"],
                                s["rc"] * (1.0 - s["alpha"] / 2.0)),
            s["rc"])
        s["alpha"] = torch.where(
            fire, torch.minimum(one, (1.0 - p["g"]) * s["alpha"] + p["g"]),
            s["alpha"])
        for k in ("t_us", "byts", "t_stage", "b_stage", "a_tus"):
            s[k] = torch.where(fire, zero, s[k])

    def class_tot(q0):
        """Per-(TC, port) occupancy [G, Q, P] from per-flow bytes
        [G, P, F] — one small matmul with the class one-hot."""
        return torch.matmul(clsF, q0.transpose(-1, -2))

    def to_flows(x_q):
        """Scatter a per-(TC, port) value [G, Q, P] to (port, flow)
        [G, P, F]; one class per flow, so one nonzero term per entry."""
        return torch.matmul(x_q.transpose(-1, -2), clsF)

    def grants(qtc, can_q, budget0):
        """Per-(TC, port) drain fractions [G, Q, P]: strict-priority
        budget grants (the fused water-fill), or WRR water-filling where
        a point schedules it."""
        frac_q = fused.priority_grants(qtc, can_q, budget0, budget_crumb,
                                       impl=impl)
        if wrr:
            # weighted water-filling over backlogged unpaused classes:
            # N_QOS rounds, each followed by the crumb clamp, in the
            # reference's order (OutputPort._wrr_fracs)
            rem = torch.where(can_q, qtc, zero)
            alloc = torch.zeros_like(qtc)
            bl = budget0
            for _ in range(N_QOS):
                wq = torch.where(rem > zero, quantaQ, zero)
                share = bl[:, None, :] * wq \
                    / torch.maximum(qsum(wq), tiny)[:, None, :]
                take = torch.minimum(share, rem)
                alloc = alloc + take
                rem = rem - take
                bl = bl - qsum(take)
                bl = torch.where(bl < budget_crumb, zero, bl)
            frac_wrr = torch.where(qtc > zero,
                                   alloc / torch.maximum(qtc, tiny), zero)
            frac_q = torch.where(is_wrr, frac_wrr, frac_q)
        return frac_q

    def drain(s, k, upf=None):
        """Stage-k ports forward up to rate*dt (:func:`grants`), pro rata
        across the flows of a class.  ``upf`` zeroes the budget of dead
        links.  Returns the drained tensor ``out`` [G, 2, P, F]."""
        qm = s["qm"]
        qtc = class_tot(qm[:, 0])                            # [G, Q, P]
        budget0 = budget if upf is None else budget * upf
        can_q = st["stage"][k] & ~s["paused"] & (qtc > zero)
        frac_q = grants(qtc, can_q, budget0)
        frac_pf = to_flows(frac_q)
        can_pf = to_flows(torch.where(can_q, one, zero))
        out = qm * frac_pf[:, None]
        qm = qm - out
        # sub-1e-9 residues vanish with their marks
        gone = (can_pf > half) & (qm[:, 0] < eps_q)
        s["qm"] = torch.where(gone[:, None], zero, qm)
        return out

    def enqueue(s, A):
        """Batch-enqueue routed arrivals ``A`` [G, 2, P, F]: proportional
        split of each class's buffer partition, one ECN knee decision per
        (TC, port) against that class's pre-batch occupancy."""
        qtc = class_tot(s["qm"][:, 0])                       # pre-batch
        tot_q = class_tot(A[:, 0])
        space_q = torch.maximum(buf_tc - qtc, zero)
        scale_q = torch.where(tot_q > space_q,
                              space_q / torch.maximum(tot_q, tiny), one)
        take = A * to_flows(scale_q)[:, None]
        lost = (A - take)[:, 0]
        # fluid go-back-N: tail-dropped bytes re-open the sender's tap
        # (or wait in the recovery ledger where it is engaged)
        if flt:
            ledger(s, lost.sum(-2))
        else:
            s["inj_lo"] = s["inj_lo"] - lost.sum(-2)
        s["sw_dropped"] = s["sw_dropped"] + lost.sum((-1, -2))
        mark_q = ecn_on[:, None, :] & (qtc > kmin_th)
        mark_pf = to_flows(torch.where(mark_q, one, zero))   # [G, P, F]
        dm = torch.where(mark_pf > half, take[:, 0] - take[:, 1], zero)
        s["ecn_marked"] = s["ecn_marked"] + dm.sum((-1, -2))
        s["qm"] = s["qm"] + take + dm[:, None] * st["sel1"]

    if sparse:
        # segmented (slot) incidence: per-(TC, port) totals are segment
        # sums over the S*F (slot, flow) entries into the flat
        # tc * (P + 1) + port bins (column P = "slot unused"), and every
        # per-port decision comes back to the flows as a gather at the
        # same addresses
        S = _STAGES_SP
        G, P = budget.shape
        Ppad = P + 1
        QPpad = N_QOS * Ppad
        stage_any = opts["stage_any"]
        qp_k, dq_k, po_k = st["qp_k"], st["dq_k"], st["po_k"]
        pad_q = torch.zeros((G, N_QOS, 1), dtype=dtype, device=device)
        pad_p = torch.zeros((G, 1), dtype=dtype, device=device)
        budget_pad = hp["budget_pad"]

        def seg(vals, plan):
            return fused.seg_sum(vals, plan, impl=impl)

        def segQ(vals, plan):
            """Per-flow values [G, N] summed into per-(TC, port) totals
            [G, Q, P] (the dummy column sliced off)."""
            return seg(vals, plan).reshape(G, N_QOS, Ppad)[..., :P]

        def gQ(x_qp, idx):
            """A per-(TC, port) value [G, Q, P] read back at the flat
            (TC, port) addresses ``idx`` [N] (0 at the dummy column)."""
            return torch.cat([x_qp, pad_q], -1).reshape(G, QPpad) \
                .index_select(-1, idx)

        def qtc_all(qm):
            """Per-(TC, port) occupancy [G, Q, P]: one segment sum of all
            slot entries (each port hosts exactly one slot's entries)."""
            return segQ(qm[:, 0].reshape(G, S * F), st["qp_flat"])

        def drain_sp(s, k, upf=None):
            """Slot-k ports forward up to rate*dt: the dense drain's
            grants on slot row k.  Returns the drained [G, 2, F] (the
            slot row is the port-level provenance)."""
            qm = s["qm"]
            qrow = qm[:, :, k]                               # [G, 2, F]
            plan = qp_k[k]
            # the grants kernel takes a contiguous demand
            qtc = segQ(qrow[:, 0], plan).contiguous()
            budget0 = budget if upf is None else budget * upf
            can_q = st["stage"][k] & ~s["paused"] & (qtc > zero)
            frac_f = gQ(grants(qtc, can_q, budget0), plan.idx)
            out = qrow * frac_f[:, None]
            left = qrow - out
            # sub-1e-9 residues vanish with their marks (dense drain)
            can_f = gQ(torch.where(can_q, one, zero), plan.idx)
            gone = (can_f > half) & (left[:, 0] < eps_q)
            left = torch.where(gone[:, None], zero, left)
            s["qm"] = qm - (qrow - left)[:, :, None] * st["row_oh"][k]
            return out

        def enqueue_sp(s, A, k):
            """Batch-enqueue slot-k output ``A`` [G, 2, F] at each flow's
            next slot: proportional split of the class partition, one ECN
            knee per (TC, port) against pre-batch occupancy."""
            plan = dq_k[k]
            qtc = qtc_all(s["qm"])
            tot_q = segQ(A[:, 0], plan)
            space_q = torch.maximum(buf_tc - qtc, zero)
            scale_q = torch.where(tot_q > space_q,
                                  space_q / torch.maximum(tot_q, tiny), one)
            take = A * gQ(scale_q, plan.idx)[:, None]
            lost = (A - take)[:, 0]
            s["inj_lo"] = s["inj_lo"] - lost
            s["sw_dropped"] = s["sw_dropped"] + lost.sum(-1)
            mark_q = ecn_on[:, None, :] & (qtc > kmin_th)
            mark_f = gQ(torch.where(mark_q, one, zero), plan.idx)
            dm = torch.where(mark_f > half, take[:, 0] - take[:, 1], zero)
            s["ecn_marked"] = s["ecn_marked"] + dm.sum(-1)
            s["qm"] = s["qm"] + (take + dm[:, None] * st["selm"])[:, :, None] \
                * st["nxt_oh"][k]

    def fold(s, hi, lo):
        """Drain a split accumulator's low part into its high part once it
        outgrows 64 KiB (bounds float32 drift over a run)."""
        full = torch.abs(s[lo]) >= fold_at
        s[hi] = s[hi] + torch.where(full, s[lo], zero)
        s[lo] = torch.where(full, zero, s[lo])

    def step(s, t, it=None):
        # ``t`` is the simulated tick (timers, event windows, fault
        # hashes), ``it`` the iteration that indexes the slot-major rings;
        # fixed dt passes it = t, adaptive dt advances t by the stride and
        # it by one.  Either is a Python int or a 0-d integer tensor.
        if it is None:
            it = t
        s = dict(s)
        now = nows[t] if isinstance(t, int) \
            else nows.index_select(0, t.reshape(1)).reshape(())
        fold(s, "injected", "inj_lo")
        fold(s, "delivered", "deliv_lo")

        # ---- 0. link failure / flap / crash events ------------------------ #
        upf = route_oh = None
        if links:
            downP, edgeP = link_state(t, p, flap)           # [G, P]
            upf = torch.where(downP, zero, one)
            failf = torch.where(edgeP, one, zero)
            if sparse:
                # the falling edge of each slot's port [G, S, F]
                failf = torch.cat([failf, pad_p], -1).index_select(
                    -1, st["po_flat"].idx).reshape(G, S, F)
            else:
                failf = failf[:, :, None]
            # in-flight bytes die with the link; fluid go-back-N
            # re-credits them for retransmission
            lostF = (s["qm"][:, 0] * failf).sum(-2)
            if flt:
                ledger(s, lostF)
                s["flt_drop"] = s["flt_drop"] + lostF.sum(-1)
            else:
                s["inj_lo"] = s["inj_lo"] - lostF
            s["sw_dropped"] = s["sw_dropped"] + lostF.sum(-1)
            s["qm"] = s["qm"] * (one - failf)[:, None]
        if flt:
            # NIC/host crash: everything queued on the crashed receiver's
            # access link dies and its admission state zeroes; cumulative
            # accounting counters and the CNP pacing clock survive
            crash_now = p["crash_at"] == t                       # [G, R]
            crashP = crash_now[:, st["owner_clamp"]] & st["owner_valid"]
            deadQ = torch.where(crashP[:, None, :, None], s["qm"], zero)
            lostC = deadQ[:, 0].sum(-2)
            ledger(s, lostC)
            s["flt_drop"] = s["flt_drop"] + lostC.sum(-1)
            s["sw_dropped"] = s["sw_dropped"] + lostC.sum(-1)
            s["qm"] = s["qm"] - deadQ
            cz = torch.where(crash_now, zero, one)
            for ck in ("resident", "strag_res", "esc_debt", "repl_debt",
                       "repl_mem", "ecn_tus"):
                s[ck] = s[ck] * cz
            s["qos_q"] = s["qos_q"] * cz[:, None, :]
            s["ring"] = s["ring"] * cz[:, None, None, :]   # [G, H, 2, R]
            s["pfc"] = s["pfc"] & ~(crash_now[:, None, :] if host_tc
                                    else crash_now)
            s["heavy"] = torch.where(crash_now, -1, s["heavy"])
            # the cleared RNIC gate unpauses the access link this very
            # tick; switch-asserted pauses persist via the carried
            # link-pause mask
            s["paused"] = torch.where(crashP[:, None, :], s["lpause"],
                                      s["paused"])
            # stochastic loss/corruption: when a link's hash fires this
            # tick, everything it drains is lost on the wire (ECN marks
            # die with the bytes)
            dropP = fault_drops(t, saltp, p["f_thr"], p["f_cthr"])

            def kill(s, out):
                """This tick's stochastic drops of one drained stage
                [G, 2, P, F], before tx accounting and forwarding."""
                dead = torch.where(dropP[:, None, :, None], out, zero)
                lost_k = dead[:, 0].sum(-2)
                ledger(s, lost_k)
                s["flt_drop"] = s["flt_drop"] + lost_k.sum(-1)
                return out - dead

        # ---- 1. senders: DCQCN advance + offer ---------------------------- #
        adv = now > p["start"]
        # the DCQCN timers only move DCQCN-lane flows; the CC block after
        # forwarding writes the Timely/HPCC rates instead
        dadv = (adv & is_dcqcn) if any_cc else adv
        adv_dt = torch.where(dadv, fdt, zero)
        a_tus = s["a_tus"] + adv_dt
        a_fire = dadv & (a_tus >= p["a_tmr"])
        s["alpha"] = torch.where(a_fire, (1.0 - p["g"]) * s["alpha"],
                                 s["alpha"])
        s["a_tus"] = torch.where(a_fire, zero, a_tus)
        t_us = s["t_us"] + adv_dt
        byts = torch.where(dadv, s["byts"] + s["rc"] * bpt, s["byts"])
        t_fire = dadv & (t_us >= p["r_tmr"])
        s["t_stage"] = s["t_stage"] + t_fire
        s["t_us"] = torch.where(t_fire, zero, t_us)
        b_fire = dadv & (byts >= p["bctr"])
        s["b_stage"] = s["b_stage"] + b_fire
        s["byts"] = torch.where(b_fire, zero, byts)
        fired = t_fire | b_fire
        stage = torch.minimum(s["t_stage"], s["b_stage"])
        s["rt"] = torch.where(fired & (stage == p["fth"]),
                              torch.minimum(p["dline"], s["rt"] + p["ai"]),
                              s["rt"])
        s["rt"] = torch.where(fired & (stage > p["fth"]),
                              torch.minimum(p["dline"], s["rt"] + p["hai"]),
                              s["rt"])
        s["rc"] = torch.where(fired,
                              torch.minimum(p["dline"],
                                            0.5 * (s["rc"] + s["rt"])),
                              s["rc"])

        gbps = torch.minimum(s["rc"], linecap)
        room = torch.maximum(p["burst"] - (s["injected"] + s["inj_lo"]),
                             zero)
        # burst-train duty cycle: the tap only opens during the on-phase
        active = adv & (~onoff | (torch.fmod(now - p["start"], period)
                                  < p["on_us"]))
        offer = torch.where(active, torch.minimum(gbps * bpt, room), zero)
        if any_msg:
            # outstanding message window: injection never runs more than
            # W * msg_bytes ahead of delivery (start-of-tick counters)
            wroom = torch.maximum(
                wbytes - (s["injected"] + s["inj_lo"]
                          - s["delivered"] - s["deliv_lo"]), zero)
            offer = torch.minimum(offer, wroom)
        # source-side backpressure: the NIC queue never overflows, bytes
        # that don't fit in the flow's class partition stay un-injected
        if sparse:
            qtcI = qtc_all(s["qm"])
            tot_q = segQ(offer, qp_k[0])
            space_q = torch.maximum(buf_tc - qtcI, zero)
            scale_q = torch.where(tot_q > space_q,
                                  space_q / torch.maximum(tot_q, tiny), one)
            take_f = offer * gQ(scale_q, qp_k[0].idx)
            s["inj_lo"] = s["inj_lo"] + take_f
            s["qm"] = s["qm"] + take_f[:, None, None, :] * st["sel_inj"]
        else:
            off_pf = occ[0] * offer[:, None, :]
            tot_q = class_tot(off_pf)                        # [G, Q, P]
            space_q = torch.maximum(buf_tc - class_tot(s["qm"][:, 0]),
                                    zero)
            scale_q = torch.where(tot_q > space_q,
                                  space_q / torch.maximum(tot_q, tiny), one)
            take_f = offer * (occ[0] * to_flows(scale_q)).sum(-2)
            s["inj_lo"] = s["inj_lo"] + take_f
            s["qm"] = s["qm"] + (occ[0] * take_f[:, None, :])[:, None] \
                * st["sel0"]

        # ---- 1.5 routing weights (after injection) ------------------------ #
        D0 = None if sparse else dest[0]
        if dyn and Sn:
            # idle-gap flowlets: a flow injecting again after more than
            # flowlet_gap ticks of silence opens a new flowlet
            act = take_f > zero
            boundary = act & ((t - s["flet_last"]) > p["flet"][:, None])
            k_new = s["flet_k"] + boundary.to(torch.int32)
            s["flet_k"] = k_new
            s["flet_last"] = torch.where(act, t, s["flet_last"])
            # per-tick spine selection: uplink occupancy and up-state per
            # candidate as [G, S, F] blocks (one-hot contractions, exact)
            occP = s["qm"][:, 0].sum(-1)                      # [G, P]
            occS = torch.einsum("sfp,gp->gsf", st["upP"], occP)
            up1 = torch.einsum("sfp,gp->gsf", st["upP"], upf)
            up2 = torch.einsum("sfp,gp->gsf", st["dnP"], upf)
            upS = st["candS"] & (up1 > half) & (up2 > half)
            free = torch.where(upS, torch.maximum(bufSF - occS, zero), zero)
            cur = s["route"]                                  # [G, F]
            cur_oh = arangeS == cur[:, None, :]               # [G, S, F]
            up_cur = (upS & cur_oh).any(-2)
            adapt = adaptive_choice(occS, upS, cur, cur_oh, up_cur, hystF,
                                    one, zero, inf)
            hsh = flowlet_hashes(arangeF, k_new, flet_scale)  # [G, F]
            pick, tot = weighted_choice(free, hsh, one, zero)
            repick = boundary | ~up_cur
            wec = torch.where(repick & (tot > zero), pick, cur)
            choice = torch.where(rmode == 2, adapt,
                                 torch.where(rmode == 1, wec, cur))
            s["reroutes"] = s["reroutes"] + \
                torch.where(choice != cur, one, zero)
            s["route"] = choice
            ch_oh = torch.where(arangeS == choice[:, None, :], one, zero)
            route_oh = ch_oh
            W = torch.where(is_spray, spray_split(free, tot, ch_oh, zero,
                                                  tiny), ch_oh)
            D0 = dest[0] + torch.einsum("gsf,sfp->gpf", W, st["upP"])

        # ---- 2. tier-ordered forwarding (cut-through within the tick) ---- #
        if sparse:
            # slot by slot in tier order; the last slot (leaf downlink)
            # delivers.  Per-port drained bytes feed the INT telemetry of
            # the CC zoo and the fabric uplinks' (slots 1, 2) tx
            if any_cc:
                txPp = torch.zeros((G, Ppad), dtype=dtype, device=device)
            for k in range(S):
                if not stage_any[k]:
                    continue
                out = drain_sp(s, k, upf)
                if any_cc or k in (1, 2):
                    txk = seg(out[:, 0], po_k[k])            # [G, P + 1]
                    if any_cc:
                        txPp = txPp + txk
                    if k in (1, 2):
                        s["tx"] = s["tx"] + txk[:, :P]
                if k < S - 1:
                    enqueue_sp(s, out, k)
            fbm = out
        else:
            out = drain(s, 0, upf)
            if flt:
                out = kill(s, out)
            if any_cc:
                # per-tick drained bytes per port: the txRate leg of the
                # HPCC-style INT signal
                txP = out[:, 0].sum(-1)
            fbm = (occ[0] * out).sum(-2)                     # [G, 2, F]
            # cross-leaf stage-0 output follows this tick's routing
            # weights
            enqueue(s, D0[..., None, :, :] * fbm[..., None, :])
            out = drain(s, 1, upf)
            if flt:
                out = kill(s, out)
            if any_cc:
                txP = txP + out[:, 0].sum(-1)
            if dyn:
                # uplink output keeps its port-level provenance: the
                # [P, F, P] map sends bytes drained at (leaf, spine) to
                # that spine's downlink toward the flow's leaf
                s["tx"] = s["tx"] + out[:, 0].sum(-1)
                enqueue(s, torch.einsum("gcpf,pfq->gcqf", out,
                                        st["T1"]))
            else:
                fbm = (occ[1] * out).sum(-2)
                enqueue(s, dest[1] * fbm[..., None, :])
            out = drain(s, 2, upf)
            if flt:
                out = kill(s, out)
            if any_cc:
                txP = txP + out[:, 0].sum(-1)
            fbm = (occ[2] * out).sum(-2)
            enqueue(s, dest[2] * fbm[..., None, :])
            out = drain(s, 3, upf)
            if flt:
                out = kill(s, out)
            if any_cc:
                txP = txP + out[:, 0].sum(-1)
            fbm = (occ[3] * out).sum(-2)
        if Hs > 1:
            # spray reorder settling: arrivals wait `settle` ticks in a
            # slot-major ring before receiver admission (settle 0 reads
            # the slot just written: pass-through)
            _slot_write(s["sring"], it % Hs, fbm)
            sidx = (it - p["settle"]) % Hs                    # [G, F]
            fbm = torch.take_along_dim(s["sring"], sidx[:, None, None, :],
                                       1)[:, 0]
        arr_b = fbm[:, 0]
        arr_m = fbm[:, 1]
        if flt:
            # crashed receivers discard arrivals until restart, then a
            # gapped go-back-N window discards the rest as duplicates
            # (crash first, then duplicate suppression; duplicates go
            # straight back to the ledger)
            crashF = ((t >= p["crash_at"])
                      & (t < p["crash_until"]))[:, recv_of]    # [G, F]
            dead_b = torch.where(crashF, arr_b, zero)
            ledger(s, dead_b)
            s["flt_drop"] = s["flt_drop"] + dead_b.sum(-1)
            arr_b = arr_b - dead_b
            arr_m = torch.where(crashF, zero, arr_m)
            dup_b = torch.where(s["gapped"], arr_b, zero)
            s["lost"] = s["lost"] + dup_b
            s["flt_drop"] = s["flt_drop"] + dup_b.sum(-1)
            arr_b = arr_b - dup_b
            arr_m = torch.where(s["gapped"], zero, arr_m)

        # ---- 2.2 delay/INT telemetry -> CC zoo updates -------------------- #
        # end-of-forwarding queue state along each flow's current path,
        # folded into rtt = base + sum(q/budget) and util = max per-hop
        # (txRate/B + qlen/(B*T)), as masked lanes
        if any_cc:
            if sparse:
                # the route slots in tier order, so a 2-tier grid sums
                # its legs in the dense engine's order
                qPp = seg(s["qm"][:, 0].reshape(G, S * F), st["po_flat"])
                legs = [tuple(x.index_select(-1, po_k[k].idx)
                              for x in (qPp, txPp, budget_pad))
                        for k in range(S) if stage_any[k]]
            else:
                qP = s["qm"][:, 0].sum(-1)                   # [G, P]
                if dyn and Sn:
                    oh = (occ[0],
                          torch.einsum("gsf,sfp->gpf", route_oh,
                                       st["upP"]),
                          torch.einsum("gsf,sfp->gpf", route_oh,
                                       st["dnP"]),
                          occ[3])
                elif dyn:
                    oh = (occ[0], occ[3])
                else:
                    oh = (occ[0], occ[1], occ[2], occ[3])
                # [P, F] (static) or [G, P, F] (routed) one-hot gathers
                legs = [tuple((leg * x[:, :, None]).sum(-2)
                              for x in (qP, txP, budget)) for leg in oh]
            qd = util = zero
            for q_l, tx_l, b_l in legs:                      # [G, F] each
                ok = b_l > zero
                qd = qd + torch.where(ok, q_l / torch.maximum(b_l, tiny),
                                      zero)
                u_l = torch.where(ok, (tx_l + q_l * (fdt * inv_brtt))
                                  / torch.maximum(b_l, tiny), zero)
                util = torch.maximum(util, u_l)
            rtt = p["base_rtt"] + qd * fdt
            ctus = s["cc_tus"] + fdt
            fire = ctus >= p["cc_upd"]
            s["cc_tus"] = torch.where(fire, zero, ctus)
            # Timely: the smoothed RTT gradient picks the branch
            ft = fire & timely_m
            diff = rtt - s["prev_rtt"]
            rd_new = (1.0 - p["tl_a"]) * s["rtt_diff"] + p["tl_a"] * diff
            s["prev_rtt"] = torch.where(ft, rtt, s["prev_rtt"])
            s["rtt_diff"] = torch.where(ft, rd_new, s["rtt_diff"])
            grad = rd_new * inv_brtt
            rc = s["rc"]
            r_tim = torch.where(
                rtt < p["t_low"], rc + p["tl_add"],
                torch.where(rtt > p["t_high"],
                            rc * (one - p["tl_beta"]
                                  * (one - p["t_high"] / rtt)),
                            torch.where(grad <= zero, rc + p["tl_add"],
                                        rc * torch.maximum(
                                            zero,
                                            one - p["tl_beta"] * grad))))
            rc_tim = torch.minimum(p["line"],
                                   torch.maximum(p["cc_minr"], r_tim))
            # HPCC: drive the max per-hop utilization toward eta
            fh = fire & hpcc_m
            mult = torch.clamp(p["hp_eta"] / torch.maximum(util, u_floor),
                               half, two)
            rc_hp = torch.minimum(p["line"],
                                  torch.maximum(p["cc_minr"],
                                                rc * mult + p["hp_ai"]))
            s["rc"] = torch.where(ft, rc_tim, torch.where(fh, rc_hp, rc))

        # ---- 3. receivers advance one tick (HostDatapath, stacked) -------- #
        arr_rb = st["recv_onehot"] * arr_b[:, None, :]       # [G, R, F]
        # QoS-classed arrivals [G, Q, R] (admission class x receiver)
        arr_cr = (st["cls_recv"] * arr_b[:, None, None, :]).sum(-1)
        arr_tot = arr_cr.sum(-2)
        # admission: RNIC buffer space granted in QoS-priority order —
        # the second fused priority water-fill
        space_r = torch.maximum(p["rnic_buf"] - s["qos_q"].sum(-2), zero)
        acc_cr = fused.priority_admit(arr_cr, space_r, impl=impl)
        accepted = acc_cr[:, 0]
        for q_i in range(1, N_QOS):
            accepted = accepted + acc_cr[:, q_i]
        if flt:
            # the first byte accepted after a crash restart stamps the
            # crash-recovery latency
            rec_hit = (t >= p["crash_until"]) & (accepted > zero) \
                & torch.isinf(s["crash_rec"])
            s["crash_rec"] = torch.where(
                rec_hit, now - p["crash_at"].to(dtype) * fdt,
                s["crash_rec"])
        s["rnic_drop"] = s["rnic_drop"] + (arr_tot - accepted)
        s["qos_q"] = s["qos_q"] + acc_cr

        ws = p["qp_bytes"] + s["resident"]
        miss = torch.clamp((ws - p["ddio"]) * inv_knee, zero, one)
        s["miss_sum"] = s["miss_sum"] + torch.where(jet, zero, miss)
        ddio_bw = torch.where(miss > 1e-9,
                              torch.minimum(p["pcie"],
                                            avail_dram / (2.0 * miss + tiny)),
                              p["pcie"])
        # drain budget granted in QoS-priority order; under Jet pool
        # pressure (< cache_safe free) the LOW class spills to DRAM (§5)
        rbudget = torch.where(jet, jet_cap, ddio_bw * bpt)
        pool_free = torch.maximum(zero, p["pool"] - s["resident"])
        spill = jet & (pool_free / p["pool"] < p["safe"])
        pf = torch.where(jet, pool_free, inf)
        drained = pool_drained = fallback = zero
        new_q = []
        for q_i in range(N_QOS):
            qq = s["qos_q"][:, q_i]
            take = torch.minimum(torch.minimum(qq, rbudget), pf)
            if q_i == N_QOS - 1:        # LOW spills instead of waiting
                take = torch.where(spill, torch.minimum(qq, rbudget), take)
                spilled = torch.where(spill, take, zero)
            else:
                spilled = zero
            pf = pf - (take - spilled)
            rbudget = rbudget - take
            new_q.append(qq - take)
            drained = drained + take
            pool_drained = pool_drained + (take - spilled)
            fallback = fallback + spilled
        s["qos_q"] = torch.stack(new_q, -2)
        s["nic_dram"] = s["nic_dram"] + \
            torch.where(jet, fallback, drained * 2.0 * miss)
        s["mem_fb"] = s["mem_fb"] + fallback
        strag_part = pool_drained * strag_share
        parts = torch.stack([pool_drained * (1.0 - strag_share),
                             strag_part], -2)
        # release ring [G, H, 2, R]: an in-place slot write
        _slot_write(s["ring"], it % H, parts)
        s["resident"] = s["resident"] + pool_drained
        s["strag_res"] = s["strag_res"] + strag_part
        s["drained"] = s["drained"] + drained

        idx = (it - p["d2"]) % H                             # [G, 2, R]
        r2 = torch.take_along_dim(s["ring"], idx[:, None], 1)[:, 0]
        r2 = torch.where(it >= p["d2"], r2, zero)
        for j, is_strag in ((0, False), (1, True)):
            r = r2[:, j]
            void = torch.minimum(r, s["esc_debt"])
            s["esc_debt"] = s["esc_debt"] - void
            r = r - void
            repay = torch.minimum(void, s["repl_debt"])
            s["repl_debt"] = s["repl_debt"] - repay
            s["repl_mem"] = torch.maximum(zero, s["repl_mem"] - repay)
            s["resident"] = torch.maximum(zero, s["resident"] - r)
            if is_strag:
                s["strag_res"] = torch.maximum(zero, s["strag_res"] - r)

        # Jet escape ladder (paper Algorithm 1)
        avail = torch.maximum(zero, p["pool"] - s["resident"]) / p["pool"]
        esc_on = jet & (avail < p["safe"])
        can_rep = s["repl_mem"] < p["mem_esc"]
        x_rep = torch.where(esc_on & can_rep,
                            torch.maximum(zero, torch.minimum(
                                s["strag_res"],
                                p["mem_esc"] - s["repl_mem"])),
                            zero)
        s["resident"] = s["resident"] - x_rep
        s["strag_res"] = s["strag_res"] - x_rep
        s["esc_debt"] = s["esc_debt"] + x_rep
        s["repl_debt"] = s["repl_debt"] + x_rep
        s["repl_mem"] = s["repl_mem"] + x_rep
        s["esc_dram"] = s["esc_dram"] + 0.1 * x_rep
        s["replaces"] = s["replaces"] + (x_rep > zero)
        x_cop = torch.where(esc_on & ~can_rep, s["strag_res"], zero)
        s["resident"] = s["resident"] - x_cop
        s["strag_res"] = s["strag_res"] - x_cop
        s["esc_debt"] = s["esc_debt"] + x_cop
        s["esc_dram"] = s["esc_dram"] + x_cop
        s["copies"] = s["copies"] + (x_cop > zero)
        avail2 = torch.maximum(zero, p["pool"] - s["resident"]) / p["pool"]
        in_danger = esc_on & (avail2 < p["danger"])
        s["ecn_tus"] = torch.where(in_danger, s["ecn_tus"] + fdt,
                                   s["ecn_tus"])
        esc_fire = in_danger & (s["ecn_tus"] >= p["cnp_iv"])
        s["ecn_tus"] = torch.where(esc_fire, zero, s["ecn_tus"])
        s["cnps"] = s["cnps"] + esc_fire
        s["ecns"] = s["ecns"] + esc_fire
        s["pool_sum"] = s["pool_sum"] + torch.where(jet, s["resident"], zero)
        s["pool_peak"] = torch.maximum(s["pool_peak"],
                                       torch.where(jet, s["resident"], zero))

        # receiver congestion signalling
        q_frac = s["qos_q"].sum(-2) / p["rnic_buf"]
        if host_tc:
            # per-class gate ([G, Q, R]): per-TC points watermark each
            # class's occupancy of its 1/N_QOS partition, legacy points
            # see the total occupancy in every row
            sel = torch.where(hpfc_b, s["qos_q"] / part_q,
                              q_frac[:, None, :])
            s["pfc"] = rx_pfc_tc & torch.where(s["pfc"], sel >= xonQ,
                                               sel > xoffQ)
            pfc_any = s["pfc"].any(-2)
        else:
            s["pfc"] = rx_pfc_en & torch.where(s["pfc"], q_frac >= p["xon"],
                                               q_frac > p["xoff"])
            pfc_any = s["pfc"]
        s["pfc_us"] = s["pfc_us"] + torch.where(pfc_any, fdt, zero)
        cnp_tus = s["cnp_tus"] + fdt
        wm_fire = wm_en & (q_frac > p["ecn_th"]) & (cnp_tus >= p["cnp_iv"])
        s["cnp_tus"] = torch.where(wm_fire, zero, cnp_tus)
        s["cnps"] = s["cnps"] + wm_fire

        # ---- 4. feedback routes back to the senders ----------------------- #
        # per-class acceptance share: a flow recovers the share its own
        # admission class received
        share_cr = torch.where(arr_cr > zero,
                               acc_cr / torch.maximum(arr_cr, tiny), zero)
        deliv = arr_b * share_cr[:, cls_of, recv_of]
        s["deliv_lo"] = s["deliv_lo"] + deliv
        # RNIC tail drops are retransmitted too (fluid RC / the ledger)
        if flt:
            ledger(s, arr_b - deliv)
        else:
            s["inj_lo"] = s["inj_lo"] - (arr_b - deliv)
        s["completion"] = torch.where(
            torch.isinf(s["completion"])
            & (s["delivered"] + s["deliv_lo"] >= p["burst_done"]),
            now, s["completion"])

        # receiver CNPs hit the heaviest recently-arriving flow (lowest
        # flow id on ties: argmax returns the first maximum); with nothing
        # arriving the previous target stays throttled
        has_arr = arr_tot > zero
        heavy_new = torch.argmax(arr_rb, -1).to(torch.int32)
        s["heavy"] = torch.where(has_arr, heavy_new, s["heavy"])
        is_heavy = arangeF == s["heavy"][:, recv_of]
        f_esc = is_heavy & esc_fire[:, recv_of]
        f_wm = is_heavy & wm_fire[:, recv_of]
        # switch ECN marks -> per-flow CNPs, paced per DCQCN NP
        s["backlog"] = s["backlog"] + arr_m
        pace_tus = s["pace_tus"] + fdt
        pace_fire = (s["backlog"] > zero) & (pace_tus >= p["cnp_iv_f"])
        s["pace_tus"] = torch.where(pace_fire, zero, pace_tus)
        s["backlog"] = torch.where(pace_fire, zero, s["backlog"])
        # CNP propagation ring [G, Hc, 3, F]: notifications generated this
        # iteration (slot it % Hc) cut their sender its own cnp_delay
        # iterations later (a per-flow gather; unwritten slots still hold
        # zero)
        fires = torch.stack([torch.where(f_esc, one, zero),
                             torch.where(f_wm, one, zero),
                             torch.where(pace_fire, one, zero)], -2)
        _slot_write(s["cring"], it % Hc, fires)
        cidx = (it - p["cnp_dly"]) % Hc                       # [G, F]
        due = torch.take_along_dim(s["cring"], cidx[:, None, None, :],
                                   1)[:, 0]
        for j in range(3):
            fire_c = due[:, j] > half
            if any_cc:
                # Timely/HPCC ignore CNPs (CongestionControl.on_cnp)
                fire_c = fire_c & is_dcqcn
            cut(s, fire_c)

        # ---- 5. per-priority PFC pause propagation ------------------------ #
        q0 = s["qm"][:, 0]
        frac_occ = (qtc_all(s["qm"]) if sparse else class_tot(q0)) / buf_tc
        s["asserted"] = can_assert[:, None, :] & \
            torch.where(s["asserted"], frac_occ >= sxon, frac_occ > sxoff)
        if sparse:
            # a slot contributes a pause iff its flow's class is asserted
            # at its own port; the pause targets the slot's ingress port
            # on the flow's class: one gather, one segment sum
            af = gQ(torch.where(s["asserted"], one, zero),
                    st["qp_flat"].idx).reshape(G, S, F)
            contrib = torch.where((af > half) & (q0 > zero), one, zero)
            link_paused = segQ(contrib.reshape(G, S * F),
                               st["pp_flat"]) > zero         # [G, Q, P]
            if "ex_f" in st:
                # under failure schedules a shallow flow's last-hop
                # contribution also pauses its other candidate downlinks
                extra = contrib[:, S - 1].index_select(-1, st["ex_f"])
                link_paused = link_paused | (segQ(extra, st["ex_flat"])
                                             > zero)
        else:
            # a flow contributes a pause iff its own class is over
            # watermark at the port it is queued in: scatter the per-class
            # assert state back to (port, flow), then to that flow's class
            # on its ingress link — [G, Q, P*F] @ [P*F, P]
            assert_pf = to_flows(torch.where(s["asserted"], one, zero))
            contrib = torch.where((assert_pf > half) & (q0 > zero), one,
                                  zero)
            contrib_q = contrib[:, None] * clsF[:, :, None, :]
            flat = contrib_q.reshape(contrib_q.shape[:2] + (-1,))
            link_paused = torch.matmul(flat, st["prev_mat"]) > zero
        link_any = link_paused.any(-2)
        s["pause_us"] = s["pause_us"] + torch.where(link_any, fdt, zero)
        s["pause_tc_us"] = s["pause_tc_us"] + \
            torch.where(link_paused, fdt, zero)
        s["ever_paused"] = s["ever_paused"] | link_any
        if flt:
            # switch-asserted pause mask, carried so a crash can rebuild
            # the pause state of its access ports without the RNIC gate
            s["lpause"] = link_paused
            # PFC-deadlock watchdog: count a tick whenever the pause graph
            # of any single class holds a directed cycle
            cyc = fused.cycle_flags(torch.where(link_paused, one, zero),
                                    st["dl_E"], n_dl)
            s["deadlock"] = s["deadlock"] + torch.where(cyc, one, zero)
        # the receiver RNIC gate: the whole access link (broadcast over
        # the class axis) or, per-TC, each admission class's own priority
        rx_gate = s["pfc"][..., st["owner_clamp"]] & st["owner_valid"]
        s["paused"] = link_paused | (rx_gate if host_tc
                                     else rx_gate[:, None, :])

        # ---- 6. message-layer crossings (MessageTracker, stacked) --------- #
        # end-of-tick byte counters (after re-credit, so go-back-N losses
        # keep the affected messages open): ceil counts starts, floor
        # counts completions, both with the MSG_COUNT_EPS slack; the
        # start-time ring plays the tracker's per-message start list
        if any_msg:
            inj_tot = s["injected"] + s["inj_lo"]
            del_tot = s["delivered"] + s["deliv_lo"]
            mb = p["m_bytes"]
            ns = torch.ceil(inj_tot / mb - eps_m).to(torch.int64)
            hw = s["m_hw"]
            new_s = torch.clamp(ns - hw, min=0)     # go-back-N: hw grows
            woff = (arangeL - (hw % Lm)[:, None, :]) % Lm      # [G, L, F]
            wmask = woff < new_s[:, None, :]
            s["mring"] = torch.where(wmask, now - fdt, s["mring"])
            hw = hw + new_s
            s["m_hw"] = hw
            nd = torch.minimum(torch.floor(del_tot / mb + eps_m)
                               .to(torch.int64), hw)
            done = s["m_done"]
            new_d = torch.clamp(nd - done, min=0)
            roff = (arangeL - (done % Lm)[:, None, :]) % Lm
            rmask = roff < new_d[:, None, :]
            lat = now - s["mring"] + p["m_extra"][:, None, :]
            s["m_lat"] = s["m_lat"] + torch.where(rmask, lat, zero).sum(-2)
            # fixed-bucket log histogram (messages.hist_bucket arithmetic);
            # latencies above its ceiling land in the overflow counter
            bi = torch.floor(torch.log(torch.maximum(lat, hist_lo) / hist_lo)
                             * inv_lr).to(torch.int64)
            over = bi > HIST_BUCKETS - 1
            bi = torch.clamp(bi, 0, HIST_BUCKETS - 1)
            inc = (arangeB == bi[:, None]) & rmask[:, None] \
                & ~over[:, None]                              # [G, B, L, F]
            s["m_hist"] = s["m_hist"] + torch.where(inc, one, zero).sum(-2)
            s["m_over"] = s["m_over"] + torch.where(rmask & over, one,
                                                    zero).sum(-2)
            s["m_done"] = done + new_d
            s["m_last"] = torch.where(new_d > 0, now, s["m_last"])

        # ---- 6.5 retransmit timers ---------------------------------------- #
        # after the message crossings, so this tick's latencies see the
        # pre-fire injected count; the re-credit reopens the sender's tap
        # from the next offer on.  The timer runs while the ledger is
        # non-empty; go-back-N backs the RTO off (k reset on delivery
        # progress), selective fires after the fixed NACK delay
        if flt:
            prog = deliv > zero
            k = torch.where(prog, 0, s["rto_k"])
            has = s["lost"] > zero
            timer = torch.where(has, s["rto_t"] + 1, 0)
            kc = torch.minimum(k, p["rto_cap"])
            dl_gbn = torch.floor(rto_f * torch.pow(p["rto_mult"],
                                                   kc.to(dtype))) \
                .to(torch.int64)
            dl = torch.where(sel_b, p["nack_ticks"], dl_gbn)
            fire = has & (timer >= dl)
            credit = torch.where(fire, s["lost"], zero)
            s["inj_lo"] = s["inj_lo"] - credit
            s["retx"] = s["retx"] + credit
            s["lost"] = torch.where(fire, zero, s["lost"])
            s["gapped"] = s["gapped"] & ~fire
            s["rto_t"] = torch.where(fire, 0, timer)
            s["rto_k"] = torch.where(fire & gbn_b,
                                     torch.minimum(k + 1, p["rto_cap"]), k)
        return s

    return step


# --------------------------------------------------------------------------- #
# Results
# --------------------------------------------------------------------------- #
def _results(s: Dict[str, np.ndarray],
             fsp: FabricSweepParams) -> Dict[str, np.ndarray]:
    sim_us = fsp.ticks * fsp.dt_us
    per_gbps = 8.0 / (sim_us * 1e-6) / 1e9
    deliv = np.asarray(s["delivered"], np.float64) \
        + np.asarray(s["deliv_lo"], np.float64)
    goodput = deliv * per_gbps
    comp = np.asarray(s["completion"], np.float64)
    tags = np.array(fsp.flow_tags)
    inc_mask = (tags == "incast")[None, :] \
        & np.isfinite(fsp.pvals["burst"])
    inc_comp = np.where(
        inc_mask.any(-1),
        np.where(inc_mask, comp, -np.inf).max(-1), np.nan)
    vic = tags == "victim"
    G = fsp.n_points
    victim = goodput[:, vic].mean(-1) if vic.any() else np.zeros(G)
    out = {
        "flow_goodput_gbps": goodput,
        "flow_delivered_bytes": deliv,
        "flow_completion_us": comp,
        "incast_completion_us": inc_comp,
        "victim_goodput_gbps": victim,
        "has_victim": np.full(G, bool(vic.any())),
        "pause_fanout": np.asarray(s["ever_paused"]).sum(-1),
        "pause_total_us": np.asarray(s["pause_us"], np.float64).sum(-1),
        # per-priority pause budget: [G, Q] microseconds summed over
        # ingress links
        "pause_tc_total_us": np.asarray(s["pause_tc_us"],
                                        np.float64).sum(-1),
        "pause_tc_fanout": (np.asarray(s["pause_tc_us"], np.float64)
                            > 0.0).sum(-1),
        "ecn_marked_bytes": np.asarray(s["ecn_marked"], np.float64),
        "switch_dropped_bytes": np.asarray(s["sw_dropped"], np.float64),
        "recv_goodput_gbps": np.asarray(s["drained"], np.float64)
        * per_gbps,
        "recv_cnp_count": np.asarray(s["cnps"], np.float64),
        "recv_escape_ecn": np.asarray(s["ecns"], np.float64),
        "recv_pfc_pause_us": np.asarray(s["pfc_us"], np.float64),
        "recv_rnic_dropped_bytes": np.asarray(s["rnic_drop"], np.float64),
        "recv_mem_fallback_bytes": np.asarray(s["mem_fb"], np.float64),
    }
    # candidate ingress links that can ever receive a pause = ports with
    # ingress support (the scalar engine's `pausable` set exactly); links
    # down for the whole window can neither pause nor carry, so they
    # leave the storm and utilization denominators
    if fsp.sparse:
        pmask = np.zeros(fsp.n_ports, bool)
        pmask[fsp.prv_port[fsp.prv_port < fsp.n_ports]] = True
        if fsp.pausable_extra is not None:
            # candidate hops of shallow flows under failure schedules
            pmask[fsp.pausable_extra] = True
    else:
        pmask = fsp.prev_onehot.sum((0, 1)) > 0
    if "fail_at" in fsp.pvals:
        dead = (fsp.pvals["fail_at"] <= 0) \
            & (fsp.pvals["fail_until"] >= fsp.ticks)         # [G, P]
    else:
        dead = np.zeros((G, fsp.n_ports), bool)
    n_pausable = (pmask[None, :] & ~dead).sum(-1)            # [G]
    out["n_pausable_links"] = n_pausable
    out["pause_storm"] = np.where(
        n_pausable > 0,
        out["pause_tc_fanout"].max(-1) / np.maximum(n_pausable, 1), 0.0)
    if fsp.any_flt:
        out["retransmit_bytes"] = np.asarray(s["retx"], np.float64).sum(-1)
        # faults-None points packed f_mtu=inf, so their count is 0
        out["dropped_pkts"] = np.asarray(s["flt_drop"], np.float64) \
            / fsp.pvals["f_mtu"]
        out["crash_recovery_us"] = np.asarray(s["crash_rec"], np.float64)
        out["deadlock_ticks"] = np.asarray(s["deadlock"], np.float64)
    else:
        for k in ("retransmit_bytes", "dropped_pkts", "deadlock_ticks"):
            out[k] = np.zeros(G)
    if fsp.any_msg:
        # per-flow counts, the point's log histogram (summed over flows)
        # and its percentile estimates; zeros wherever no message
        # completed
        mmask = np.isfinite(fsp.pvals["m_bytes"])            # [G, F]
        cnt = np.where(mmask, np.asarray(s["m_done"], np.float64), 0.0)
        tot = cnt.sum(-1)
        hist = np.asarray(s["m_hist"], np.float64).sum(-1)   # [G, B]
        lat_sum = np.asarray(s["m_lat"], np.float64).sum(-1)
        mbytes = np.where(mmask, fsp.pvals["m_bytes"], 0.0)
        # latencies above the histogram's ceiling sit in the overflow
        # counter; a rank inside that mass reports the ceiling
        ovf = np.where(mmask, np.asarray(s["m_over"], np.float64), 0.0)
        ov_tot = ovf.sum(-1)
        out["msg_count"] = cnt
        out["msg_count_total"] = tot
        out["msg_hist"] = hist
        out["msg_overflow_count"] = ov_tot
        for q, key in ((50.0, "msg_p50_us"), (99.0, "msg_p99_us"),
                       (99.9, "msg_p999_us")):
            out[key] = percentile_from_counts(hist, q, overflow=ov_tot)
        out["msg_lat_mean_us"] = np.where(
            tot > 0.0, lat_sum / np.maximum(tot, 1.0), 0.0)
        out["msg_rate_mops"] = tot / sim_us
        out["msg_goodput_gbps"] = (cnt * mbytes).sum(-1) * per_gbps
        out["msg_last_done_us"] = np.where(
            mmask, np.asarray(s["m_last"], np.float64), 0.0)
        out["has_messages"] = mmask.any(-1)
    else:
        out["msg_count_total"] = np.zeros(G)
        out["has_messages"] = np.zeros(G, bool)
    if "reroutes" in s:
        rr = np.asarray(s["reroutes"], np.float64)
        out["flow_reroutes"] = rr
        out["reroute_count"] = rr.sum(-1)
    else:
        out["reroute_count"] = np.zeros(G)
    if "tx" in s:
        # per-uplink utilization (leaf -> spine; sparse pod grids add the
        # spine -> super-spine tier); links dead for the whole window
        # leave the mean and max
        tx = np.asarray(s["tx"], np.float64)
        cap = fsp.pvals["gbps"] * 1e9 / 8.0 * (sim_us * 1e-6)
        util = np.where(cap > 0.0, tx / np.maximum(cap, 1e-30), 0.0)
        up_mask = (fsp.stage_mask[1] | fsp.stage_mask[2]) if fsp.sparse \
            else fsp.stage_mask[1]
        alive = up_mask[None, :] & ~dead
        out["uplink_util"] = np.where(up_mask[None, :], util, 0.0)
        if up_mask.any():
            out["uplink_util_max"] = np.where(alive, util, 0.0).max(-1)
            out["uplink_util_mean"] = np.where(alive, util, 0.0).sum(-1) \
                / np.maximum(alive.sum(-1), 1)
        else:
            out["uplink_util_max"] = np.zeros(G)
            out["uplink_util_mean"] = np.zeros(G)
    return out


def _opts(fsp: FabricSweepParams) -> dict:
    """The packing's capability flags for :func:`_make_step`."""
    return {"dyn": fsp.dyn_route, "wrr": fsp.any_wrr,
            "host_tc": fsp.host_tc, "Hs": fsp.settle_ring,
            "Sn": fsp.n_spines, "flap": fsp.any_flap, "cc": fsp.any_cc,
            "msg": fsp.any_msg, "Lm": fsp.msg_ring, "flt": fsp.any_flt,
            "sparse": fsp.sparse, "fail": fsp.pack_fail,
            # slots with no port are skipped when the step is built
            "stage_any": [bool(m.any()) for m in fsp.stage_mask]}


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
CHAIN = 8           # ticks (iterations) a captured graph chains
_ADAPTIVE_DENSE_ONLY = ("adaptive_dt macro-ticking is dense-engine only; "
                        "run sparse grids at the fine tick")


class FabricRun:
    """A packed grid set up on a device; :meth:`run` advances it to
    ``fsp.ticks`` and returns the results (once).

    ``graph="auto"`` keeps the state in static buffers and runs chains of
    ``chain`` steps through a :class:`~repro_torch.fabric.tickgraph.TickChain`:
    on CUDA the constructor captures them as CUDA graphs (warm-up and
    capture take ``capture_s`` seconds) and :meth:`run` replays them; on
    the CPU they run without capture.  ``graph=False`` runs the eager
    loop with a Python tick.  ``adaptive`` (an :class:`AdaptiveConfig`,
    with ``graph="auto"`` only) runs the reference's adaptive loop: one
    iteration is a fine step, the whole-grid stride ``k`` and the macro
    advance over ``k - 1`` more ticks, as the reference's ``while_loop``
    body does (at ``k == 1`` the advance leaves the state as it is, so
    this equals its numpy loop, which skips it); the host reads the tick
    once a batch of iterations (``batches``).

    The kernel launch counts (``fused.LAUNCHES.read()``) hold the
    warm-up's launches (two iterations on a scratch copy, set-up) and
    then, on CUDA, one for each launch a replay executes, added on the
    card.  ``launches_captured()`` is the arithmetic beside them: the
    launches captured for one iteration times the iterations run.

    :meth:`load` re-arms a built fixed-dt run with another packing of
    the same structure (a farm chunk), in place, so its captured graphs
    replay for it; :func:`cached_run` hands out such runs.
    """

    def __init__(self, fsp: FabricSweepParams, device=None,
                 dtype: Optional[torch.dtype] = None, impl: str = "auto",
                 graph="auto", chain: int = CHAIN,
                 adaptive: Optional[fused.AdaptiveConfig] = None):
        if graph not in ("auto", False):
            raise ValueError(f"graph must be 'auto' or False, got {graph!r}")
        if graph is False and adaptive is not None:
            raise ValueError("adaptive dt runs on the static-buffer body "
                             "(graph='auto'); graph=False is the fixed-dt "
                             "eager loop")
        if fsp.sparse and adaptive is not None:
            raise ValueError(_ADAPTIVE_DENSE_ONLY)
        dev = resolve_device(device)
        dt = resolve_dtype(dev, dtype)
        fused.resolve_impl(impl, dev)        # reject a bad impl up front
        cuda = dev.type == "cuda"
        p = {k: _to_device(v, dt, dev)
             for k, v in _np_params(fsp, _np_dtype(dt)).items()}
        st = {k: _to_device(v, dt, dev) for k, v in _static(fsp).items()}
        if fsp.sparse:
            st.update(_seg_plans(fsp, dev))
        self.fsp, self.device, self.dtype = fsp, dev, dt
        self.adaptive = adaptive
        self.p = p
        self.hoisted = _hoist(p, _opts(fsp), fsp.dt_us, dt, dev)
        self.step = _make_step(st, p, self.hoisted, fsp.dt_us, fsp.ring_len,
                               fsp.cnp_ring, fsp.ticks, dt, dev, impl,
                               _opts(fsp))
        self.stride = None if adaptive is None else fused.make_stride_fn(
            fsp, p, _opts(fsp), adaptive, dt)
        self.iterations = self.batches = 0
        self.capture_s = 0.0
        self.chain = None
        state = _init_state(fsp, p, dt, dev)
        if graph is False:
            self.state = state
            return
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        if adaptive is None:
            counters = (self.t,)
            body = self._fixed_body
        else:
            self.it = torch.zeros((), dtype=torch.int64, device=dev)
            counters = (self.t, self.it)
            body = self._adaptive_body
        t0 = time.perf_counter()
        self.chain = TickChain(body, state, counters, chain, capture=cuda,
                               counts=fused.LAUNCHES)
        self.capture_s = time.perf_counter() - t0
        self.state = self.chain.state

    def load(self, fsp: FabricSweepParams) -> None:
        """Re-arm this run with ``fsp``, a packing of the same structure
        (a farm chunk), in place: its parameters into the run's
        parameter tensors, the hoisted per-point constants recomputed
        into their storage, every state buffer and ring back to its
        initial value, the tick to 0.  A captured graph reads all of
        these by address, so it then replays ``fsp``'s run.  Raises
        ``ValueError`` unless ``fsp`` matches the run's ``structure_key``,
        ``n_points``, ``ticks``, ``ring_len``, ``cnp_ring`` and ``dt_us``,
        for an adaptive run (the farm runs fixed dt only) and for a
        ``graph=False`` run (it keeps no static buffers)."""
        if self.adaptive is not None:
            raise ValueError("load runs fixed dt only: an adaptive run "
                             "cannot be re-armed")
        if self.chain is None:
            raise ValueError("load re-arms static buffers: a graph=False "
                             "run cannot be re-armed")
        mine = _run_key(self.fsp)
        theirs = _run_key(fsp)
        if theirs != mine:
            raise ValueError(
                "load needs a packing of the run's structure: (structure_"
                "key, n_points, ticks, ring_len, cnp_ring, dt_us) "
                f"{theirs} != {mine}")
        for k, v in _np_params(fsp, _np_dtype(self.dtype)).items():
            self.p[k].copy_(_to_device(v, self.dtype, self.device))
        opts = _opts(fsp)
        for k, v in _hoist(self.p, opts, fsp.dt_us, self.dtype,
                           self.device).items():
            self.hoisted[k].copy_(v)
        for k, v in _init_state(fsp, self.p, self.dtype,
                                self.device).items():
            self.state[k].copy_(v)
        self.t.zero_()
        self.fsp = fsp
        self.iterations = self.batches = 0

    def launches_captured(self) -> Dict[str, int]:
        """The launches captured for one iteration times the iterations
        run (empty unless the tick was captured)."""
        per = self.chain.per_iteration if self.chain is not None else {}
        return {k: n * self.iterations for k, n in per.items()}

    def _fixed_body(self, s):
        s = self.step(s, self.t, self.t)
        self.t.add_(1)
        return s

    def _adaptive_body(self, s):
        """One adaptive iteration: the reference's ``while_loop`` body."""
        s1 = self.step(s, self.t, self.it)
        k = self.stride(s, s1, self.t)
        s1 = fused.macro_advance(s, s1, k.to(self.dtype) - 1.0)
        self.t.add_(k)
        self.it.add_(1)
        return s1

    def _batch(self, n: int) -> int:
        self.chain.run(n)
        return int(self.t)

    def run(self) -> Dict[str, np.ndarray]:
        fsp = self.fsp
        if self.chain is not None:
            if self.adaptive is None:
                self.chain.run(fsp.ticks)
                self.iterations = fsp.ticks
            else:
                self.iterations, self.batches = adaptive_batches(
                    fsp.ticks, self.adaptive.max_stride, self._batch)
        else:
            s = self.state
            for t in range(fsp.ticks):
                s = self.step(s, t)
            self.state, self.iterations = s, fsp.ticks
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # copies: on the CPU ``.cpu()`` would hand out the state buffers
        # themselves, which a later load or run overwrites
        res = _results({k: v.to("cpu", copy=True).numpy()
                        for k, v in self.state.items()}, fsp)
        if self.adaptive is not None:
            res["adaptive_iterations"] = np.full(fsp.n_points,
                                                 self.iterations)
        return res


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _run_key(fsp: FabricSweepParams) -> tuple:
    """What a built run fixes: packings equal on it run on one run."""
    return (fsp.structure_key, fsp.n_points, fsp.ticks, fsp.ring_len,
            fsp.cnp_ring, fsp.dt_us)


_RUNS: Dict[tuple, FabricRun] = {}
_RUNS_MAX = 8          # built runs kept (state, graphs), as the reference
# monotonic count of new runs built in this process (a CUDA graph capture
# on the card, a build on the CPU): the sweep farm reads it before and
# after each chunk; after the first chunk of each shape it must not move
GRAPH_CAPTURES = 0


def cached_run(fsp: FabricSweepParams, device=None,
               dtype: Optional[torch.dtype] = None) -> FabricRun:
    """A fixed-dt :class:`FabricRun` armed with ``fsp``: one built for an
    earlier packing of the same structure (:func:`_run_key`), device and
    dtype, re-armed by :meth:`FabricRun.load`, or a new one
    (``GRAPH_CAPTURES`` + 1).  At most ``_RUNS_MAX`` runs are kept, the
    oldest dropped first."""
    global GRAPH_CAPTURES
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    key = _run_key(fsp) + (str(dev), dt)
    run = _RUNS.get(key)
    if run is not None:
        run.load(fsp)
        return run
    GRAPH_CAPTURES += 1
    run = FabricRun(fsp, device=dev, dtype=dt)
    while len(_RUNS) >= _RUNS_MAX:
        _RUNS.pop(next(iter(_RUNS)))
    _RUNS[key] = run
    return run


def run_packed(fsp: FabricSweepParams, device=None,
               dtype: Optional[torch.dtype] = None,
               impl: str = "auto", graph="auto",
               adaptive: Optional[fused.AdaptiveConfig] = None
               ) -> Dict[str, np.ndarray]:
    """Advance a packed grid (see :func:`run_fabric_sweep` and
    :class:`FabricRun`)."""
    return FabricRun(fsp, device=device, dtype=dtype, impl=impl,
                     graph=graph, adaptive=adaptive).run()


def run_fabric_sweep(scenarios: Sequence, device=None,
                     dtype: Optional[torch.dtype] = None,
                     impl: str = "auto", graph="auto",
                     adaptive_dt: bool = False,
                     adaptive: Optional[fused.AdaptiveConfig] = None,
                     incidence: str = "auto"
                     ) -> Dict[str, np.ndarray]:
    """Advance a grid of fabric scenarios through the full multi-host
    recurrence at once; returns ``{metric: array}`` aligned with the input
    order (arrays are ``[G]``, ``[G, F]`` or ``[G, R]`` — flow order is the
    scenario flow list, receiver order is ``sorted({flow.dst})``), with
    the keys the reference returns.

    ``device=None`` runs on CUDA and raises ``RuntimeError`` without it;
    pass ``device="cpu"`` for the CPU.  ``dtype`` defaults to float32
    (the only CUDA dtype); float64 on the CPU is the oracle mode.
    ``impl="auto"`` launches the CUDA kernels (the water-fills, and the
    segment sum of the sparse engine) on the card and runs their plain
    versions on the CPU.  ``graph="auto"`` replays the tick as captured
    CUDA graphs on the card (the same static-buffer chains, uncaptured,
    on the CPU); ``graph=False`` runs the eager fixed-dt loop (see
    :class:`FabricRun`).

    ``incidence`` picks the queue-state layout: ``"dense"`` is the
    ``[G, 2, P, F]`` port x flow formulation, ``"sparse"`` the segmented
    ``[G, 2, 6, F]`` slot incidence whose cost grows with flows x hops
    instead of flows x ports.  ``"auto"`` picks sparse exactly where the
    topology has a super-spine tier (3-level pod fabrics); ``"sparse"``
    runs any static 2-tier grid too.  The sparse engine takes static
    ECMP with failure/flap windows and the CC zoo; dynamic routing, the
    message layer and fault injection raise ``ValueError`` there.

    ``adaptive_dt=True`` (or an explicit :class:`AdaptiveConfig` via
    ``adaptive=``) turns on macro-tick coarsening: quiet stretches of the
    whole grid advance ``k * dt`` per iteration in closed form, with fine
    ticks near every event; the result gains ``adaptive_iterations``
    (``[G]``, the iteration count).  It is dense-engine only: on a
    sparse grid it raises ``ValueError``.
    """
    if incidence not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown incidence {incidence!r}")
    sparse = incidence == "sparse" or (
        incidence == "auto"
        and any(bool(s.topology.super_spines) for s in scenarios))
    cfg = adaptive if adaptive is not None \
        else (fused.AdaptiveConfig() if adaptive_dt else None)
    if sparse and cfg is not None:
        raise ValueError(_ADAPTIVE_DENSE_ONLY)
    return run_packed(FabricSweepParams.from_scenarios(scenarios,
                                                       sparse=sparse),
                      device=device, dtype=dtype, impl=impl, graph=graph,
                      adaptive=cfg)
