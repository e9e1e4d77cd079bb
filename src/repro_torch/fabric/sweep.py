"""Vectorized parameter-sweep engine for the receiver datapath, in PyTorch.

The port of ``repro.fabric.sweep``: the per-host fluid state of one RDMA
receiver (DCQCN machine, RNIC queue, DDIO/Jet drain, release rings,
escape ladder, PFC/CNP signalling) packed into ``[P]`` tensors, one per
sweep point, advanced one tick at a time for all points at once.  The
tick loop runs eagerly from the host with the tick a Python int; nothing
in it reads a device value back, so the host only waits at the end.

Float32 only, as the reference: every constant is a float32 and every
operation keeps the reference's order, so the CPU run is bit-equal to the
reference's ``backend="numpy"`` (itself float32).

The release rings are circular ``[P, H]`` tensors: slot ``t % H`` is
written every tick with that tick's scheduled release and read ``d``
ticks later at ``(t - d) % H``, ``d`` a per-point integer tensor.  H
exceeds the largest delay, so a slot is always read before the ring
wraps over it.  Indices use ``%`` (floor semantics, as numpy and JAX).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.datapath import hold_us_baseline, hold_us_jet
from ..core.simulator import SimConfig

_F = np.float32


# --------------------------------------------------------------------------- #
# Parameter packing
# --------------------------------------------------------------------------- #
_SCALARS = [
    # (name, extractor)
    ("jet", lambda c: 1.0 if c.mode == "jet" else 0.0),
    ("pfc_en", lambda c: 1.0 if c.pfc_enabled else 0.0),
    ("wm_cnp", lambda c: 1.0 if c.rnic_ecn_cnp else 0.0),
    ("line", lambda c: c.line_rate_gbps * c.incast_senders),
    ("line1", lambda c: c.line_rate_gbps),
    ("cap", lambda c: np.inf if c.offered_gbps is None else c.offered_gbps),
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
    # DCQCN
    ("dline", lambda c: c.dcqcn.line_rate_gbps),
    ("minr", lambda c: c.dcqcn.min_rate_gbps),
    ("g", lambda c: c.dcqcn.g),
    ("a_tmr", lambda c: c.dcqcn.alpha_timer_us),
    ("r_tmr", lambda c: c.dcqcn.rate_timer_us),
    ("bctr", lambda c: c.dcqcn.byte_counter_mb * (1 << 20)),
    ("ai", lambda c: c.dcqcn.ai_rate_gbps),
    ("hai", lambda c: c.dcqcn.hai_rate_gbps),
    ("fth", lambda c: c.dcqcn.f_threshold),
]


@dataclasses.dataclass
class SweepParams:
    """Stacked per-point parameters (all float32 arrays of shape [P])."""
    vals: Dict[str, np.ndarray]
    d_base: np.ndarray            # int32 release delays (ticks)
    d_strag: np.ndarray
    n_points: int
    ticks: int
    dt_us: float
    ring_len: int

    @classmethod
    def from_configs(cls, configs: Sequence[SimConfig]) -> "SweepParams":
        if not configs:
            raise ValueError("empty sweep grid")
        dt = configs[0].dt_us
        ticks = int(configs[0].sim_time_s * 1e6 / dt)
        for c in configs:
            if c.dt_us != dt or int(c.sim_time_s * 1e6 / c.dt_us) != ticks:
                raise ValueError("sweep points must share dt and sim_time")
            if c.cpu_membw_schedule is not None:
                raise ValueError("cpu_membw_schedule is not sweepable; "
                                 "use repro_torch.core.run_sim for "
                                 "scheduled contention")
        vals = {name: np.array([fn(c) for c in configs], dtype=_F)
                for name, fn in _SCALARS}
        d_b, d_s = [], []
        for c in configs:
            hold = hold_us_jet(c) if c.mode == "jet" \
                else hold_us_baseline(c)
            d_b.append(max(1, int(hold / dt)))
            d_s.append(max(1, int(hold * c.straggler_mult / dt)))
        ring = int(max(max(d_b), max(d_s))) + 2
        return cls(vals=vals, d_base=np.array(d_b, np.int32),
                   d_strag=np.array(d_s, np.int32),
                   n_points=len(configs), ticks=ticks, dt_us=dt,
                   ring_len=ring)


def grid_configs(mk, mode: str = "jet", sim_time_s: float = 0.01,
                 **axes: Sequence) -> Tuple[List[SimConfig], List[dict]]:
    """Cartesian sweep grid: ``mk(mode, sim_time_s=..., **point)`` per
    combination of the ``axes`` lists (axes in sorted name order).
    Returns (configs, point-dicts)."""
    names = sorted(axes)
    configs, points = [], []
    for combo in itertools.product(*(axes[n] for n in names)):
        pt = dict(zip(names, combo))
        configs.append(mk(mode, sim_time_s=sim_time_s, **pt))
        points.append(pt)
    return configs, points


# --------------------------------------------------------------------------- #
# The per-tick step
# --------------------------------------------------------------------------- #
def _make_step(p: Dict[str, torch.Tensor], dt: float, H: int,
               d_base: torch.Tensor, d_strag: torch.Tensor):
    """Build ``step(state, t) -> state`` over ``[P]`` tensors (rings
    ``[P, H]``).  ``p`` maps parameter names to float32 ``[P]`` tensors,
    ``d_base`` / ``d_strag`` are the int64 release delays.  Loop-invariant
    subexpressions are hoisted; their bits are the ones the reference
    computes inside its tick."""
    dev = p["jet"].device

    def c(x):                            # 0-d float32 constant
        return torch.tensor(_F(x), dtype=torch.float32, device=dev)

    bpt = c(1e9 / 8.0 * dt * 1e-6)       # bytes per (Gbps * tick)
    fdt = c(dt)
    zero, one = c(0.0), c(1.0)
    minus_g = 1.0 - p["g"]
    jet = p["jet"] > 0.5
    avail_dram = torch.maximum(zero, p["membw"] - p["cpu_bw"])
    knee_ddio = p["knee"] * p["ddio"]
    jet_bpt = torch.minimum(p["pcie"], p["line1"] * 4.0) * bpt
    strag_share = torch.where(jet, p["sfrac"], zero)
    base_share = 1.0 - strag_share
    pfc_en = p["pfc_en"] > 0.5
    wm_en = p["wm_cnp"] > 0.5
    delays = (("ring_b", d_base, False), ("ring_s", d_strag, True))

    def cut(s, fire):
        """DCQCN on_cnp for points where ``fire`` holds."""
        s["rt"] = torch.where(fire, s["rc"], s["rt"])
        s["rc"] = torch.where(
            fire, torch.maximum(p["minr"],
                                s["rc"] * (1.0 - s["alpha"] / 2.0)),
            s["rc"])
        s["alpha"] = torch.where(
            fire, torch.minimum(one, minus_g * s["alpha"] + p["g"]),
            s["alpha"])
        for k in ("t_us", "byts", "t_stage", "b_stage", "a_tus"):
            s[k] = torch.where(fire, zero, s[k])

    def step(s, t: int):
        s = dict(s)
        # ---- DCQCN advance ------------------------------------------------ #
        s["a_tus"] = s["a_tus"] + fdt
        a_fire = s["a_tus"] >= p["a_tmr"]
        s["alpha"] = torch.where(a_fire, minus_g * s["alpha"], s["alpha"])
        s["a_tus"] = torch.where(a_fire, zero, s["a_tus"])
        s["t_us"] = s["t_us"] + fdt
        s["byts"] = s["byts"] + s["rc"] * bpt
        t_fire = s["t_us"] >= p["r_tmr"]
        s["t_stage"] = s["t_stage"] + t_fire
        s["t_us"] = torch.where(t_fire, zero, s["t_us"])
        b_fire = s["byts"] >= p["bctr"]
        s["b_stage"] = s["b_stage"] + b_fire
        s["byts"] = torch.where(b_fire, zero, s["byts"])
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

        # ---- sender -> RNIC ----------------------------------------------- #
        offered = torch.minimum(torch.minimum(s["rc"], p["line"]), p["cap"])
        arriving = torch.where(s["pfc"], zero, offered * bpt)
        space = p["rnic_buf"] - s["rnic_q"]
        accepted = torch.minimum(arriving, torch.maximum(space, zero))
        s["dropped"] = s["dropped"] + (arriving - accepted)
        s["rnic_q"] = s["rnic_q"] + accepted

        # ---- drain RNIC -> host ------------------------------------------- #
        ws = p["qp_bytes"] + s["resident"]
        miss = torch.clamp((ws - p["ddio"]) / knee_ddio, zero, one)
        s["miss_sum"] = s["miss_sum"] + torch.where(jet, zero, miss)
        ddio_bw = torch.where(miss > c(1e-9),
                              torch.minimum(p["pcie"],
                                            avail_dram
                                            / (2.0 * miss + c(1e-30))),
                              p["pcie"])
        ddio_drained = torch.minimum(s["rnic_q"], ddio_bw * bpt)
        pool_free = torch.maximum(zero, p["pool"] - s["resident"])
        jet_drained = torch.minimum(torch.minimum(s["rnic_q"], jet_bpt),
                                    pool_free)
        drained = torch.where(jet, jet_drained, ddio_drained)
        s["nic_dram"] = s["nic_dram"] + \
            torch.where(jet, zero, ddio_drained * 2.0 * miss)
        s["rnic_q"] = s["rnic_q"] - drained
        strag_part = drained * strag_share
        # this tick's scheduled release goes into slot t % H, read at
        # t + d (< t + H), before the ring wraps over the slot
        s["ring_b"][:, t % H] = drained * base_share
        s["ring_s"][:, t % H] = strag_part
        s["resident"] = s["resident"] + drained
        s["strag_res"] = s["strag_res"] + strag_part
        s["drained"] = s["drained"] + drained

        # ---- post-NIC consumption ----------------------------------------- #
        for ring_key, delay, is_strag in delays:
            # releases scheduled ``delay`` ticks ago (zero before warm-up)
            idx = ((t - delay) % H)[:, None]
            r = torch.gather(s[ring_key], 1, idx)[:, 0]
            r = torch.where(t >= delay, r, zero)
            void = torch.minimum(r, s["esc_debt"])
            s["esc_debt"] = s["esc_debt"] - void
            r = r - void
            repay = torch.minimum(void, s["repl_debt"])
            s["repl_debt"] = s["repl_debt"] - repay
            s["repl_mem"] = torch.maximum(zero, s["repl_mem"] - repay)
            s["resident"] = torch.maximum(zero, s["resident"] - r)
            if is_strag:
                s["strag_res"] = torch.maximum(zero, s["strag_res"] - r)

        # ---- Jet escape ladder -------------------------------------------- #
        avail = torch.maximum(zero, p["pool"] - s["resident"]) / p["pool"]
        esc_on = jet & (avail < p["safe"])
        can_replace = s["repl_mem"] < p["mem_esc"]
        x_rep = torch.where(esc_on & can_replace,
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
        x_cop = torch.where(esc_on & ~can_replace, s["strag_res"], zero)
        s["resident"] = s["resident"] - x_cop
        s["strag_res"] = s["strag_res"] - x_cop
        s["esc_debt"] = s["esc_debt"] + x_cop
        s["esc_dram"] = s["esc_dram"] + x_cop
        s["copies"] = s["copies"] + (x_cop > zero)
        avail2 = torch.maximum(zero, p["pool"] - s["resident"]) / p["pool"]
        in_danger = esc_on & (avail2 < p["danger"])
        s["ecn_tus"] = torch.where(in_danger, s["ecn_tus"] + fdt,
                                   s["ecn_tus"])
        fire_ecn = in_danger & (s["ecn_tus"] >= p["cnp_iv"])
        s["ecn_tus"] = torch.where(fire_ecn, zero, s["ecn_tus"])
        s["cnps"] = s["cnps"] + fire_ecn
        s["ecns"] = s["ecns"] + fire_ecn
        jet_res = torch.where(jet, s["resident"], zero)
        s["pool_sum"] = s["pool_sum"] + jet_res
        s["pool_peak"] = torch.maximum(s["pool_peak"], jet_res)

        # ---- congestion signalling ---------------------------------------- #
        q_frac = s["rnic_q"] / p["rnic_buf"]
        s["pfc"] = pfc_en & torch.where(s["pfc"], q_frac >= p["xon"],
                                        q_frac > p["xoff"])
        s["pfc_us"] = s["pfc_us"] + torch.where(s["pfc"], fdt, zero)
        s["cnp_tus"] = s["cnp_tus"] + fdt
        fire_wm = wm_en & (q_frac > p["ecn_th"]) \
            & (s["cnp_tus"] >= p["cnp_iv"])
        s["cnp_tus"] = torch.where(fire_wm, zero, s["cnp_tus"])
        s["cnps"] = s["cnps"] + fire_wm

        # rate cuts, in the order run_sim applies them
        cut(s, fire_ecn)
        cut(s, fire_wm)
        return s

    return step


_ZERO_KEYS = ("t_us", "byts", "t_stage", "b_stage", "a_tus", "ecn_tus",
              "rnic_q", "resident", "strag_res", "esc_debt", "repl_debt",
              "repl_mem", "dropped", "drained", "nic_dram", "esc_dram",
              "miss_sum", "pool_sum", "pool_peak", "cnps", "ecns",
              "replaces", "copies", "pfc_us")


def _init_state(p: Dict[str, torch.Tensor], n_points: int, H: int):
    dev = p["jet"].device

    def z(*sh):
        return torch.zeros((n_points,) + sh, dtype=torch.float32,
                           device=dev)

    s = {k: z() for k in _ZERO_KEYS}
    s["rc"] = p["dline"] + z()
    s["rt"] = p["dline"] + z()
    s["alpha"] = torch.ones(n_points, dtype=torch.float32, device=dev)
    s["cnp_tus"] = p["cnp_iv"] + z()   # allow an immediate first CNP
    s["pfc"] = torch.zeros(n_points, dtype=torch.bool, device=dev)
    s["ring_b"] = z(H)
    s["ring_s"] = z(H)
    return s


def _results(s: Dict[str, np.ndarray],
             sp: SweepParams) -> Dict[str, np.ndarray]:
    sim_us = sp.ticks * sp.dt_us
    drained = np.asarray(s["drained"], np.float64)
    miss_n = np.maximum(1, sp.ticks * (1.0 - sp.vals["jet"]))
    return {
        "goodput_gbps": drained * 8.0 / (sim_us * 1e-6) / 1e9,
        "cnp_count": np.asarray(s["cnps"], np.float64),
        "escape_ecn": np.asarray(s["ecns"], np.float64),
        "escape_replaces": np.asarray(s["replaces"], np.float64),
        "escape_copies": np.asarray(s["copies"], np.float64),
        "ddio_miss_rate": np.asarray(s["miss_sum"], np.float64) / miss_n,
        "pool_peak_bytes": np.asarray(s["pool_peak"], np.float64),
        "pool_avg_bytes": np.asarray(s["pool_sum"], np.float64) / sp.ticks,
        "pfc_pause_us": np.asarray(s["pfc_us"], np.float64),
        "dropped_bytes": np.asarray(s["dropped"], np.float64),
        "nic_dram_gbps": np.asarray(s["nic_dram"], np.float64) * 8.0
        / (sim_us * 1e-6) / 1e9,
        "escape_dram_gbps": np.asarray(s["esc_dram"], np.float64) * 8.0
        / (sim_us * 1e-6) / 1e9,
    }


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #
def run_sweep(configs: Sequence[SimConfig],
              device=None) -> Dict[str, np.ndarray]:
    """Advance every config in ``configs`` through the full fluid
    recurrence at once; returns ``{metric: array[P]}`` aligned with the
    input order, the keys the reference returns.

    ``device=None`` runs on CUDA and raises ``RuntimeError`` without it;
    pass ``device="cpu"`` for the CPU.  The engine computes in float32 on
    both."""
    sp = SweepParams.from_configs(configs)
    dev = resolve_device(device)
    p = {k: torch.as_tensor(v, device=dev) for k, v in sp.vals.items()}
    d_b = torch.as_tensor(sp.d_base.astype(np.int64), device=dev)
    d_s = torch.as_tensor(sp.d_strag.astype(np.int64), device=dev)
    step = _make_step(p, sp.dt_us, sp.ring_len, d_b, d_s)
    s = _init_state(p, sp.n_points, sp.ring_len)
    for t in range(sp.ticks):
        s = step(s, t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return _results({k: v.cpu().numpy() for k, v in s.items()}, sp)
