"""Federated server: the FairEnergy training loop on the controller API.

Round r (paper Sec. II-A + Algorithm 1), all on the trainer's device:
  1. Rayleigh fading for the round and every client's minibatches, both
     pure in (seed, round) (``repro_torch.random``, the JAX package's
     streams);
  2. every client runs its local steps — all clients at once through the
     ``torch.func`` batched client step — giving stacked flat updates
     [N, D] and their norms ||u_i|| (score-norm kernel);
  3. the controller maps the round's ``RoundObservation`` to a
     ``RoundDecision`` (x, gamma, B[, bits]) (dual-solve kernels in the
     FairEnergy solver), hard-masked by the battery, which is debited;
  4. the updates are block-top-k sparsified to their gamma_i (top-k
     kernel), quantized at their width on the quantized path, combined by
     the aggregator (the masked |D_i|-weighted mean, or the defended one)
     and applied.

This is the port of ``repro.fl.server`` with its optional device profile
(computation energy and finite batteries, ``device_profile``), lossy
uplink (``link_cfg``: burst interference, outages with bounded HARQ and
backoff, outage-aware pricing), quantized payloads (a joint
``FairEnergyConfig.bits_grid`` or profile default widths), timed rounds
(``async_cfg``: deadlines, partial energy, the staleness buffer,
harvesting), faults (``fault_cfg``: crashes, corrupted payloads,
channel-estimate error, churn), defended aggregation (``defense``),
checkpoints of the full carry (``save_checkpoint``/``restore_checkpoint``,
``run_scanned(ckpt_dir=..., start_round=...)``), the pathloss drift of
moving clients (``mobility``), the sampled decide path over a pool of
candidates (``hierarchy``) and client-axis sharding over a ``clients`` or
``(clusters, clients)`` mesh (``mesh``; see ``repro_torch.sharding``).
Without any of these options the round is the legacy one, step for step.

Under a mesh each rank holds its ``n_local`` rows of the ghost-padded
client stack (and of the stale buffer): it samples, trains, sparsifies,
quantizes, corrupts, screens and clips them and partially aggregates
them, all-gathers ``u_norms``, losses and the clip's norms before
anything reads them, runs the controller on the full replicated ``[N]``
observation, and all-reduces the partial sums (in float64,
``weighted_sum``, so the aggregate's bits do not depend on the mesh) and
the counts — on a hierarchy mesh in two stages, over ``clients`` and then
over ``clusters``; params, controller, battery, defense and link state
and the logs are replicated. The trimmed mean gathers the whole update
matrix.

The round body runs the reference's steps in its order
(``_make_round_core``, after the client step of ``_round``), on a lane's
key streams (``RoundKeys``: fading, controller, sampling, harvest, fault
and link keys off one base key) and its carry (``Carry``: params,
controller state, battery, stale buffer, defense and link state).
``run_round``, ``run``, ``run_scanned`` and ``run_sweep`` all drive that
one body, and so do the reference's engine factories, ``make_round_engine``
(one round over explicit state) and ``make_scan_engine`` (the multi-round
program). PyTorch runs eagerly, so ``run_scanned`` is a loop over rounds
that materializes its logs on the host once per chunk, and ``run_sweep``
runs its seed and config lanes one after another (the reference's
sharded sweep does the same).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import random as prng
from ..checkpoint import ckpt as _ckpt
from ..core.channel import WirelessNetwork, comm_energy, comm_time, round_gains
from ..core.controllers import (Controller, ControllerContext,
                                RoundObservation, make_controller)
from ..core.energy import UNLIMITED_J, alive_mask, comp_energy, comp_time
from ..core.fairenergy import FEParams
from ..core.faults import (DefenseConfig, FaultConfig, arrival_mask,
                           channel_estimate, corrupt_draw, corrupt_payload,
                           crash_draw, make_aggregator)
from ..core.hierarchy import HierarchyConfig, wrap_controller
from ..core.link import (LinkConfig, LinkState, attempt_energy,
                         attempt_outcomes, attempt_time, burst_channel,
                         burst_step, expected_attempts, init_link_state,
                         outage_probability)
from ..core.rounds import (AsyncConfig, AsyncState, apply_harvest,
                           best_case_round_time, harvest_rates,
                           init_async_state, partial_round_energy,
                           resolve_deadline, round_wall_clock,
                           staleness_weight)
from ..core.streams import (CTRL_STREAM, FAULT_STREAM, HARVEST_STREAM,
                            LINK_STREAM, POOL_STREAM, SAMPLE_STREAM)
from ..data.pipeline import (client_sample_keys, sample_client_batches,
                             stack_client_datasets)
from ..devices import resolve_device
from ..sharding.fl import (CLIENTS_AXIS, check_clients_mesh,
                           client_shard_count, client_shard_index,
                           shard_client_data)
from . import compression
from .client import make_batched_client_step
from .updates import tree_spec, unflatten_update, weighted_sum

__all__ = ["Carry", "FederatedTrainer", "RoundKeys", "RoundLog", "UNLIMITED_J",
           "make_round_engine", "make_scan_engine", "resolve_device",
           "seed_keys", "weighted_sum"]


class RoundKeys(NamedTuple):
    """One lane's key streams: fading uses the base key itself (folded by
    round), the others ``fold_in(base, STREAM)`` with the JAX package's
    stream tags. Keys stay on the host."""
    fade: torch.Tensor
    ctrl: torch.Tensor
    sample: torch.Tensor
    harvest: torch.Tensor
    fault: torch.Tensor
    link: torch.Tensor


def seed_keys(base: torch.Tensor) -> RoundKeys:
    """The key streams of the lane whose base key is ``base``
    (``random.PRNGKey(seed)``), as the reference's ``_seed_keys``."""
    return RoundKeys(fade=base, ctrl=prng.fold_in(base, CTRL_STREAM),
                     sample=prng.fold_in(base, SAMPLE_STREAM),
                     harvest=prng.fold_in(base, HARVEST_STREAM),
                     fault=prng.fold_in(base, FAULT_STREAM),
                     link=prng.fold_in(base, LINK_STREAM))


class Carry(NamedTuple):
    """What one round hands the next (what a checkpoint holds)."""
    params: dict
    ctrl_state: Any
    battery: torch.Tensor           # [N] J (inf = unlimited)
    astate: Optional[AsyncState]    # None unless the staleness buffer is on
    fstate: Any                     # None unless the clip tracker is on
    lstate: Optional[LinkState]     # None unless the burst chain is on


@dataclasses.dataclass
class RoundLog:
    round: int
    selected: np.ndarray
    gamma: np.ndarray
    bandwidth: np.ndarray
    energy: np.ndarray          # J per client — total (comm + comp)
    accuracy: float             # NaN on rounds skipped by eval_every
    loss: float
    n_selected: int
    battery: Optional[np.ndarray] = None  # J per client after the round
    # --- timed-round fields (None on untimed rounds) -------------------
    t_round: Optional[float] = None       # simulated wall-clock of the
    #                                       round (s): slowest selected
    #                                       comp+comm, capped at T_round
    made: Optional[np.ndarray] = None     # [N] bool — selected AND inside
    #                                       the deadline (aggregated)
    n_late: Optional[int] = None          # selected clients past deadline
    n_stale: Optional[int] = None         # buffered updates folded in
    # --- fault-telemetry fields (None unless faults or the defended
    #     aggregator are on) ---------------------------------------------
    n_faulted: Optional[int] = None       # crashed + corrupted participants
    n_rejected: Optional[int] = None      # updates screened out (or all of
    #                                       them on a rejected round)
    clip_frac: Optional[float] = None     # fraction of accepted updates
    #                                       norm-clipped this round
    fallback: Optional[bool] = None       # solver fallback round
    # --- link-reliability fields (None unless the link model is on) ----
    n_retx: Optional[int] = None          # retransmissions this round
    n_outage: Optional[int] = None        # retx-exhausted clients (update
    #                                       dropped, energy still charged)
    goodput_frac: Optional[float] = None  # delivered bits / bits on air
    e_retx: Optional[float] = None        # J spent on retransmissions
    # --- quantized-payload fields (None unless the path is on) ---------
    bits: Optional[np.ndarray] = None     # [N] transmitted width (0 on
    #                                       unselected rows)
    e_saved: Optional[float] = None       # J saved vs a 32-bit payload
    wall_s: Optional[float] = None        # host seconds for the round,
    #                                       device work included

    @property
    def total_energy(self) -> float:
        return float(self.energy.sum())


@dataclasses.dataclass(frozen=True)
class _AsyncRuntime:
    """The timed-round quantities resolved from an ``AsyncConfig``:
    ``deadline`` is the concrete T_round in seconds (``deadline_q``
    resolved); ``rates=None`` disables harvesting."""
    deadline: float
    staleness: bool
    staleness_a: float
    cap: torch.Tensor                 # [N] J battery capacity (inf ok)
    rates: Optional[torch.Tensor]     # [N] J/round mean harvest, or None
    gamma_floor: float


@dataclasses.dataclass(frozen=True)
class _FaultsRuntime:
    """The fault-injection knobs resolved from a ``FaultConfig``."""
    crash_rate: float
    corrupt_rate: float
    corrupt_mode: str
    corrupt_scale: float
    h_err_std: float
    churn_dwell: int
    churn_away: float


@dataclasses.dataclass(frozen=True)
class _LinkRuntime:
    """The link-reliability quantities resolved from a ``LinkConfig``."""
    outage: bool
    margin: float                 # linear fade margin 10^(dB/10)
    max_retx: int
    backoff_s: float
    bursty: bool
    burst_p: float
    burst_q: float
    noise_rise: float             # (N0 + I_burst) / N0 >= 1
    observe_burst: bool
    price_outage: bool


def _nest(params: dict) -> dict:
    """Dotted names -> the nested dict of the JAX package's params tree
    (``conv0.w`` -> ``{"conv0": {"w": ...}}``), for checkpoint keys."""
    out: dict = {}
    for name, v in params.items():
        *head, leaf = name.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _unnest(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_unnest(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@dataclasses.dataclass(frozen=True)
class _Physics:
    """What the round's energy and time accounting reads besides the
    decision: the clients' computation energy and time and the channel
    scalars (the reference carries them inside each runtime). ``b_tot`` is
    the trainer's own B_tot, under a config lane too (the lane's rides in
    the controller state): it only prices the unselected rows, which are
    masked."""
    e_cmp: torch.Tensor               # [N] J computation energy a round
    t_cmp: torch.Tensor               # [N] s computation time a round
    b_tot: float
    s_bits: float
    i_bits: float
    n0: float


@dataclasses.dataclass(frozen=True)
class _QuantRuntime:
    """The quantized-payload path: the [N] width a controller without the
    joint (gamma, bits) grid transmits at (32 unless the device profile
    carries tier widths)."""
    default_bits: torch.Tensor


class _ClientShard:
    """This rank's rows ``[i0, i0 + n_local)`` of the ghost-padded client
    axis (``n_padded`` rows, the first ``n_real`` real) and the collectives
    over a clients mesh; without a mesh the rows are all of them and every
    collective is the identity. ``group`` spans every rank of the mesh in
    shard order (gathers); ``reduce_groups`` are the all-reduce stages, the
    innermost axis first."""

    def __init__(self, n_real: int, n_padded: Optional[int] = None,
                 n_local: Optional[int] = None, i0: int = 0, group=None,
                 reduce_groups: tuple = ()):
        self.n_real = n_real
        self.n_padded = n_real if n_padded is None else n_padded
        self.n_local = self.n_padded if n_local is None else n_local
        self.i0, self.group, self.reduce_groups = i0, group, reduce_groups

    @classmethod
    def of_mesh(cls, mesh, mesh_axis, n_real: int, n_padded: int):
        """The shard of this rank on ``mesh`` (None: the whole axis)."""
        if mesh is None:
            return cls(n_real, n_padded)
        axes = check_clients_mesh(mesh, mesh_axis)
        n_dev = client_shard_count(mesh, mesh_axis)
        if n_padded % n_dev:
            raise ValueError(f"padded client count {n_padded} does not divide "
                             f"the {axes} mesh axes ({n_dev}); stack the "
                             f"datasets with pad_to_multiple={n_dev}")
        n_local = n_padded // n_dev
        group = (mesh.get_group(axes[0]) if len(axes) == 1
                 else dist.group.WORLD)
        return cls(n_real, n_padded, n_local,
                   client_shard_index(mesh, mesh_axis) * n_local, group,
                   tuple(mesh.get_group(a) for a in reversed(axes)))

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a [n_local, ...] tensor, in rank order: the
        [n_padded, ...] tensor."""
        if self.group is None:
            return local
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The [n_real] vector from every rank's [n_local] rows."""
        return self.gather_rows(local)[:self.n_real]

    def local(self, vec: torch.Tensor, fill) -> torch.Tensor:
        """This rank's rows of an [n_real] vector, ghost rows taking
        ``fill``."""
        if self.group is None:
            return vec
        pad = vec.new_full((self.n_padded - self.n_real,), fill)
        return torch.cat([vec, pad])[self.i0:self.i0 + self.n_local]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over every rank, in place: one all-reduce a stage
        (``clients``, then ``clusters`` on a hierarchy mesh)."""
        for group in self.reduce_groups:
            dist.all_reduce(t, group=group)
        return t


def _make_round_core(*, controller, spec, weights, server_lr: float,
                     block: int = compression.DEFAULT_BLOCK,
                     skip_full_sparsify: bool = True,
                     shard: Optional[_ClientShard] = None,
                     async_rt: Optional[_AsyncRuntime] = None,
                     fault_rt: Optional[_FaultsRuntime] = None,
                     aggregator=None, link_rt: Optional[_LinkRuntime] = None,
                     quant_rt: Optional[_QuantRuntime] = None,
                     physics: Optional[_Physics] = None):
    """The round body after the client step: observe, decide, hard mask,
    energy and time accounting, battery debit, sparsify, quantize,
    corrupt, aggregate, stale fold, apply — in the reference's order. One
    body for ``FederatedTrainer`` (``_round``: ``run_round``, ``run``,
    ``run_scanned``, ``run_sweep``) and both engine factories.

    Returns ``core(params, updates, u_norms, h, P, r, key, ctrl_state,
    battery=None, astate=None, hkey=None, fstate=None, fkey=None,
    lstate=None, lkey=None) -> (params, RoundDecision, ctrl_state, battery,
    astate, fstate, lstate, extras)``. ``updates`` [n_local, D] and
    ``u_norms`` [n_local] are this rank's rows (``shard``; the norms are
    gathered to the [N] observation here); ``key`` is the controller's key
    for the round; ``hkey``, ``fkey``, ``lkey`` the harvest, fault and link
    streams' keys. ``weights`` [n_padded] are the |D_i| weights of the
    whole padded axis. ``extras`` holds the log lanes the active paths add
    (timed, fault, link, quantized). Without ``battery`` the decision is
    not hard-masked and nothing is debited (the reference's battery-free
    core); the timed, fault, link and quantized paths need it, and
    ``physics``."""
    shard = shard if shard is not None else _ClientShard(int(weights.shape[0]))
    agg = make_aggregator(aggregator if aggregator is not None else "mean")
    faulty, link, arun, frun = (fault_rt is not None, link_rt,
                                async_rt, fault_rt)
    telemetry = faulty or bool(getattr(agg, "enabled", False))
    quant = quant_rt is not None
    link_out = link is not None and link.outage
    link_burst = link is not None and link.bursty
    if (arun is not None or faulty or link is not None or quant) \
            and physics is None:
        raise ValueError("the timed, fault, link and quantized paths need "
                         "the round's physics (_Physics)")
    w_data = torch.as_tensor(weights, dtype=torch.float32)[
        shard.i0:shard.i0 + shard.n_local]
    gather = None if shard.group is None else shard.gather_rows
    n_shards = shard.n_padded // shard.n_local

    def core(params, updates, u_norms, h, P, r, key, ctrl_state,
             battery=None, astate=None, hkey=None, fstate=None, fkey=None,
             lstate=None, lkey=None):
        if battery is None and (arun is not None or faulty or link is not None
                                or quant):
            raise ValueError("the timed, fault, link and quantized paths need "
                             "the battery carry (pass battery=torch.full((n,), "
                             "inf) for unlimited capacities)")
        dev = updates.device
        wd = w_data.to(dev)
        # the controller sees the real clients' [N] observation in every
        # layout: gather before any use, ghosts cut off
        u_norms = shard.gather(u_norms)
        n = u_norms.shape[0]
        if physics is not None:
            b_tot, n0 = physics.b_tot, physics.n0
            s_bits, i_bits = physics.s_bits, physics.i_bits
            e_cmp, t_cmp = physics.e_cmp, physics.t_cmp
        if link_burst:
            # one Gilbert-Elliott transition a round; the burst derates
            # the physics channel (a raised noise floor is a scaled gain)
            burst = burst_step(lkey, r, lstate.burst, link.burst_p,
                               link.burst_q)
            lstate = LinkState(burst=burst)
            h_phys = burst_channel(h, burst, link.noise_rise)
        else:
            h_phys = h
        # the controller's channel belief: the quiet-state channel unless
        # it observes the burst, then lognormal-noised under the
        # channel-estimate fault; the transmission realizes on h_phys
        h_obs = h_phys if (link_burst and link.observe_burst) else h
        if faulty and frun.h_err_std > 0.0:
            h_obs = channel_estimate(fkey, r, h_obs, frun.h_err_std)
        h = h_phys
        alive = alive_mask(battery) if battery is not None else None
        if faulty and frun.churn_dwell > 0:
            # departed clients join the hard mask; (re)arrivals get fresh
            # per-client controller state
            present, arrived = arrival_mask(fkey, r, n, frun.churn_away,
                                            frun.churn_dwell)
            alive = alive & present.to(dev)
            if hasattr(controller, "reset_clients"):
                ctrl_state = controller.reset_clients(ctrl_state,
                                                      arrived.to(dev))
        t_obs = None
        if arun is not None:
            # best-case round time: a client that cannot make the deadline
            # under any allocation is priced out through the hard mask
            t_obs = best_case_round_time(
                t_cmp, P, h_obs, b_tot=b_tot, gamma_floor=arun.gamma_floor,
                s_bits=s_bits, i_bits=i_bits, n0=n0)
            alive = alive & (t_obs <= arun.deadline)
        p_out = e_scale = None
        if link_out:
            # per-attempt outage at the decided operating point: the belief
            # sets the design SNR, the physics the realized fade mean; a
            # per-client scalar, priceable before the decision
            p_out = outage_probability(h_obs, h, link.margin)
            if link.price_outage:
                e_scale = expected_attempts(p_out)
        obs = RoundObservation(u_norms=u_norms, h=h_obs, P=P, round=r,
                               key=key, alive=alive, t_round=t_obs,
                               e_scale=e_scale)
        dec, ctrl_state = controller.decide(obs, ctrl_state)
        if battery is not None:
            # hard mask, whatever the controller decided: a depleted client
            # transmits nothing and is charged nothing
            x = dec.x & alive
            mf = x.to(torch.float32)
            dec = dec._replace(x=x, gamma=dec.gamma * mf,
                               bandwidth=dec.bandwidth * mf,
                               energy=dec.energy * mf,
                               bw_used=torch.sum(dec.bandwidth * mf))
        xf_sel = dec.x.to(torch.float32)
        bits_w = bits_fac = None
        if quant:
            # transmitted width: the solver's joint decision, else the
            # profile default; 32 on unselected rows
            bits_dec = (dec.bits if dec.bits is not None
                        else quant_rt.default_bits)
            bits_w = torch.where(dec.x, bits_dec, 32.0)
            bits_fac = bits_w / 32.0
            if dec.bits is None:
                # the controller priced a 32-bit payload but the wire
                # carries the default width: re-charge at the payload
                # gamma (same allocation, realized channel)
                b_q = torch.where(dec.x, dec.bandwidth, b_tot)
                g_q = torch.where(dec.x, dec.gamma, 1.0)
                dec = dec._replace(energy=xf_sel * (
                    comm_energy(g_q * bits_fac, b_q, P, h, s_bits, i_bits,
                                n0) + e_cmp))

        def pay(g):
            # payload-equivalent gamma: a bits-wide payload is gamma*bits/32
            # of the full-precision one
            return g * bits_fac if quant else g

        if (battery is not None and arun is None and not faulty
                and link is None):
            # debit the round's spend; charge floors at 0 (inf stays inf)
            battery = torch.clamp(battery - dec.energy, min=0.0)
        if (faulty and frun.h_err_std > 0.0) or (link_burst and not link_out):
            # the controller priced its belief (h_est and/or the quiet
            # channel); the transmission pays the physics channel, same
            # allocation (b/gamma guards keep the unselected lanes finite).
            # With outages on, the retry accounting below re-prices instead
            b_safe = torch.where(dec.x, dec.bandwidth, b_tot)
            g_safe = torch.where(dec.x, dec.gamma, 1.0)
            dec = dec._replace(energy=xf_sel * (
                comm_energy(pay(g_safe), b_safe, P, h, s_bits, i_bits, n0)
                + e_cmp))
        crashed = cfrac = None
        if faulty and frun.crash_rate > 0.0:
            crashed_m, cfrac = crash_draw(fkey, r, n, frun.crash_rate)
            crashed, cfrac = dec.x & crashed_m.to(dev), cfrac.to(dev)
        delivered = lost = t_link = None
        if link_out:
            # bounded HARQ: each attempt a full airtime of the decided
            # allocation, a backoff slot before each retry; the realized
            # cost replaces the priced energy
            b_safe = torch.where(dec.x, dec.bandwidth, b_tot)
            g_safe = torch.where(dec.x, dec.gamma, 1.0)
            t1 = comm_time(pay(g_safe), b_safe, P, h, s_bits, i_bits, n0)
            attempts, delivered = attempt_outcomes(lkey, r, p_out,
                                                   link.max_retx)
            attempts_f = attempts.to(torch.float32)
            t_link = attempt_time(attempts_f, t1, link.backoff_s)
            e_retx_vec = xf_sel * (attempts_f - 1.0) * P * t1
            dec = dec._replace(energy=xf_sel * (
                attempt_energy(attempts_f, t1, P) + e_cmp))
            # a crashed client counts as a crash, not an outage
            lost = dec.x & ~delivered
            if crashed is not None:
                lost = lost & ~crashed

        made = late = None
        extras = {}
        if arun is not None:
            # realized round time under the actual allocation (inf on
            # unselected rows, read only through the selection mask); with
            # outages, the whole retry timeline
            t_comm = (t_link if link_out else
                      comm_time(pay(dec.gamma), dec.bandwidth, P, h, s_bits,
                                i_bits, n0))
            t_total = t_cmp + t_comm
            feasible = dec.x & (t_total <= arun.deadline)
            # a crashed client is neither made nor late; a retx-exhausted
            # one neither, but it pays like a late one
            made = feasible if crashed is None else feasible & ~crashed
            late = (dec.x & ~feasible if crashed is None
                    else dec.x & ~feasible & ~crashed)
            if delivered is not None:
                made = made & delivered
                late = late & delivered
            e_full = dec.energy
            if not arun.staleness:
                # a dropped update is abandoned at the deadline: computation
                # first, then the prorated transmission (never above full)
                drop = late if lost is None else late | lost
                e_part = partial_round_energy(t_cmp, t_comm, e_cmp, P,
                                              arun.deadline)
                dec = dec._replace(energy=torch.where(
                    made, dec.energy,
                    torch.where(drop, torch.minimum(e_part, dec.energy),
                                0.0)))
            # with staleness the transmission completes in the background:
            # late clients pay their full energy
            if crashed is not None:
                # a crash at the fraction cfrac of the client's own round
                # (capped at the deadline unless the transmission would
                # have gone on in the background)
                t_cap = (t_total if arun.staleness
                         else torch.clamp(t_total, max=arun.deadline))
                t_c = cfrac * torch.where(dec.x, t_cap, 0.0)
                e_crash = partial_round_energy(t_cmp, t_comm, e_cmp, P, t_c)
                dec = dec._replace(energy=torch.where(
                    crashed, torch.minimum(e_crash, e_full), dec.energy))
            battery = torch.clamp(battery - dec.energy, min=0.0)
            battery = apply_harvest(battery, arun.cap, hkey, r, arun.rates)
            t_wall = round_wall_clock(dec.x, t_total, arun.deadline)
            extras = dict(t_round=t_wall, made=made,
                          n_late=torch.sum(late.to(torch.int32)),
                          n_stale=torch.zeros((), dtype=torch.int32,
                                              device=dev))
        elif faulty or link is not None:
            if crashed is not None:
                # untimed rounds prorate a crash over the client's own
                # comp+comm (the retry timeline with outages on)
                t_comm_f = (t_link if link_out else comm_time(
                    pay(torch.where(dec.x, dec.gamma, 1.0)),
                    torch.where(dec.x, dec.bandwidth, b_tot), P, h, s_bits,
                    i_bits, n0))
                t_c = cfrac * torch.where(dec.x, t_cmp + t_comm_f, 0.0)
                e_crash = partial_round_energy(t_cmp, t_comm_f, e_cmp, P, t_c)
                dec = dec._replace(energy=torch.where(
                    crashed, torch.minimum(e_crash, dec.energy), dec.energy))
            # the deferred debit, after the link and crash accounting
            battery = torch.clamp(battery - dec.energy, min=0.0)

        # only clients inside the deadline, not crashed and delivered enter
        # this round's aggregate
        part = made if made is not None else dec.x
        if crashed is not None and made is None:
            part = dec.x & ~crashed
        if delivered is not None and made is None:
            part = part & delivered
        cm = flavor = None
        if faulty and frun.corrupt_rate > 0.0:
            # corruption hits the transmitted payload: drawn over every
            # client, applied to this rank's rows below
            cm, flavor = corrupt_draw(fkey, r, n, frun.corrupt_rate)
            cm, flavor = cm.to(dev), flavor.to(dev)
        # unselected rows carry zero weight; gamma=1 lets them copy
        # through. Late rows keep their gamma: the buffered update is the
        # sparsified payload the client transmits. Sparsify, quantize,
        # corrupt and the partial aggregate run on this rank's rows (ghost
        # rows: weight 0, gamma 1, 32 bits); the sums are all-reduced
        gamma = torch.where(dec.x, torch.clamp(dec.gamma, 1e-6, 1.0), 1.0)
        sparse = compression.batch_block_topk(updates, shard.local(gamma, 1.0),
                                              block=block,
                                              skip_full=skip_full_sparsify)
        if quant:
            # client-side quantization of the sparse payload at the
            # transmitted width, dequantized right back; before the
            # in-transit corruption, which the quantizer must not screen
            sparse = compression.quantize_rows(sparse,
                                               shard.local(bits_w, 32.0))
        if cm is not None:
            sparse = corrupt_payload(sparse, shard.local(cm, False),
                                     shard.local(flavor, 0.0),
                                     frun.corrupt_mode, frun.corrupt_scale)
        # the aggregator: the legacy weighted mean, or the defended one,
        # which returns the screened and clipped rows the buffer must hold
        partial, wsum, fstate, dstats, sparse = agg(
            sparse, shard.local(part.to(torch.float32), 0.0), wd, fstate,
            gather=gather, n_shards=n_shards)
        if arun is not None and arun.staleness:
            # the staleness buffer (this rank's rows): age the pending
            # slots by the round's wall-clock, fold the completed ones in
            # with the w(tau) discount, then buffer this round's late
            # updates (a newer one replaces an older, staler one)
            buf, age, t_rem = astate
            pending = age >= 0
            age = torch.where(pending, age + 1, age)
            t_rem = torch.where(pending, t_rem - extras["t_round"], t_rem)
            ready = pending & (t_rem <= 0.0)
            w_stale = (wd * staleness_weight(age, arun.staleness_a)
                       * ready.to(torch.float32))
            wsum = wsum + torch.sum(w_stale.double())
            partial = partial + weighted_sum(w_stale, buf)
            late_l = shard.local(late, False)
            t_new = shard.local(torch.clamp(t_total - arun.deadline, min=0.0),
                                0.0)
            buf = torch.where(late_l[:, None], sparse, buf)
            age = torch.where(late_l, 0, torch.where(ready, -1, age))
            t_rem = torch.where(late_l, t_new, torch.where(ready, 0.0, t_rem))
            astate = AsyncState(buf=buf, age=age, t_rem=t_rem)
            extras["n_stale"] = shard.all_reduce(
                torch.sum(ready.to(torch.int32)))
        partial, wsum = shard.all_reduce(partial), shard.all_reduce(wsum)
        agg_vec = (partial / torch.clamp(wsum, min=1e-12)).to(torch.float32)
        agg_vec = torch.where(wsum > 0.0, agg_vec * server_lr, 0.0)
        if telemetry:
            n_part = torch.sum(part.to(torch.int32))
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            n_rej = shard.all_reduce(dstats.get("n_rejected", zero).clone())
            n_clip = shard.all_reduce(dstats.get("n_clipped", zero).clone())
            # last-resort guard: whatever slipped past the defenses (or an
            # undefended run's corrupted payloads) must not poison the
            # params — reject the whole round, every accepted participant
            # counted rejected
            ok_round = torch.all(torch.isfinite(agg_vec))
            agg_vec = torch.where(ok_round, agg_vec, 0.0)
            n_rej = n_rej + torch.where(ok_round, 0,
                                        torch.clamp(n_part - n_rej, min=0))
            n_faulted = zero
            if crashed is not None:
                n_faulted = n_faulted + torch.sum(crashed.to(torch.int32))
            if cm is not None:
                n_faulted = n_faulted + torch.sum((cm & part).to(torch.int32))
            extras.update(
                n_faulted=n_faulted, n_rejected=n_rej,
                clip_frac=(n_clip.to(torch.float32)
                           / torch.clamp(n_part - n_rej, min=1)
                           .to(torch.float32)),
                fallback=torch.as_tensor(dec.fallback, dtype=torch.bool,
                                         device=dev))
        delta = unflatten_update(agg_vec, spec)
        params = {k: p + delta[k].to(p.dtype) for k, p in params.items()}
        if quant:
            # e_saved: the same allocation at a 32-bit payload minus the
            # realized single-attempt quantized charge
            b_q = torch.where(dec.x, dec.bandwidth, b_tot)
            g_q = torch.where(dec.x, dec.gamma, 1.0)
            de = (comm_energy(g_q, b_q, P, h, s_bits, i_bits, n0)
                  - comm_energy(pay(g_q), b_q, P, h, s_bits, i_bits, n0))
            extras.update(bits=torch.where(dec.x, bits_w, 0.0),
                          e_saved=torch.sum(xf_sel * de))
        if link_out:
            # link telemetry over the selected clients that did not crash;
            # goodput is link-layer: only exhausted payloads are dead air
            nc_f = (xf_sel if crashed is None
                    else xf_sel * (~crashed).to(torch.float32))
            ok_m = dec.x & delivered
            if crashed is not None:
                ok_m = ok_m & ~crashed
            d_bits = pay(g_safe) * s_bits + i_bits
            tx_bits = torch.sum(nc_f * attempts_f * d_bits)
            ok_bits = torch.sum(torch.where(ok_m, d_bits, 0.0))
            extras.update(
                n_retx=torch.sum(nc_f * (attempts_f - 1.0)).to(torch.int32),
                n_outage=torch.sum(lost.to(torch.int32)),
                goodput_frac=torch.where(
                    tx_bits > 0.0, ok_bits / torch.clamp(tx_bits, min=1e-30),
                    1.0),
                e_retx=torch.sum(nc_f * e_retx_vec))
        elif link is not None:
            # burst-only: one lossless attempt per selection
            zero_i = torch.zeros((), dtype=torch.int32, device=dev)
            extras.update(n_retx=zero_i, n_outage=zero_i,
                          goodput_frac=torch.ones((), device=dev),
                          e_retx=torch.zeros((), device=dev))
        return (params, dec, ctrl_state, battery, astate, fstate, lstate,
                extras)

    return core


def make_round_engine(*, controller, spec, weights, server_lr: float,
                      use_pallas: bool = False,
                      block: int = compression.DEFAULT_BLOCK,
                      skip_full_sparsify: bool = True,
                      fault_rt: Optional[_FaultsRuntime] = None,
                      aggregator=None, physics: Optional[_Physics] = None):
    """One round over explicit state, the reference's standalone engine:
    ``core(params, updates, u_norms, h, P, r, key, ctrl_state[, battery,
    astate, hkey, fstate, fkey]) -> (new_params, RoundDecision,
    ctrl_state[, battery])``, or with faults or a defended ``aggregator``
    ``(new_params, dec, ctrl_state, battery, astate, fstate, extras)``.

    ``controller`` is a port controller (``make_controller``), ``spec`` the
    params' ``TreeSpec`` (``updates.tree_spec``), ``weights`` the [N]
    |D_i| weights, ``fault_rt`` and ``aggregator`` the port's runtime
    objects as ``FederatedTrainer`` builds them (``physics`` with a fault
    runtime). ``block`` and ``skip_full_sparsify`` set the top-k's block
    width and all-full skip. ``use_pallas`` is taken for the reference's
    signature: as everywhere in the port, the tensors' device picks the
    route (the plain versions on the CPU, the kernels on the card). PyTorch
    runs eagerly, so nothing is compiled: the returned function is the
    round body itself."""
    del use_pallas
    body = _make_round_core(controller=controller, spec=spec, weights=weights,
                            server_lr=server_lr, block=block,
                            skip_full_sparsify=skip_full_sparsify,
                            fault_rt=fault_rt, aggregator=aggregator,
                            physics=physics)
    telemetry = (fault_rt is not None
                 or bool(getattr(aggregator, "enabled", False)))

    def core(params, updates, u_norms, h, P, r, key, ctrl_state,
             battery=None, astate=None, hkey=None, fstate=None, fkey=None):
        (params, dec, ctrl_state, battery, astate, fstate, _,
         extras) = body(params, updates, u_norms, h, P, r, key, ctrl_state,
                        battery, astate, hkey, fstate, fkey)
        if telemetry:
            return params, dec, ctrl_state, battery, astate, fstate, extras
        if battery is not None:
            return params, dec, ctrl_state, battery
        return params, dec, ctrl_state

    return core


def make_scan_engine(*, controller, spec, weights, server_lr: float,
                     client_step, eval_fn, pathloss, P, rayleigh: bool,
                     local_steps: int, batch: int, use_pallas: bool = False,
                     block: int = compression.DEFAULT_BLOCK, unroll: int = 1,
                     mesh=None, mesh_axis: str = CLIENTS_AXIS,
                     n_real: Optional[int] = None,
                     async_rt: Optional[_AsyncRuntime] = None,
                     fault_rt: Optional[_FaultsRuntime] = None,
                     aggregator=None, mobility=None,
                     link_rt: Optional[_LinkRuntime] = None,
                     quant_rt: Optional[_QuantRuntime] = None,
                     physics: Optional[_Physics] = None):
    """The multi-round program: ``scan_fn(params, ctrl_state, battery,
    astate, fstate, lstate, data, keys, start_round, last_round,
    eval_every, n_rounds) -> (params, ctrl_state, battery, astate, fstate,
    lstate, outs)`` runs rounds ``start_round .. start_round + n_rounds -
    1``: each round's fading (``round_gains`` on ``pathloss``, with
    ``mobility``), minibatches (``sample_client_batches`` of ``data``, a
    ``ClientData``, at ``local_steps`` x ``batch``), ``client_step(params,
    batches) -> (updates, u_norms, losses)`` (``make_batched_client_step``),
    the round body ``FederatedTrainer`` runs (``_make_round_core``), and
    ``eval_fn`` on rounds ``r % eval_every == 0`` and on ``last_round``
    (NaN elsewhere). ``outs`` are the reference's stacked per-round logs
    as [n_rounds, ...] tensors: ``x``, ``gamma``, ``bandwidth``,
    ``energy``, ``accuracy``, ``loss``, ``battery``, plus ``t_round``,
    ``made``, ``n_late``, ``n_stale`` (``async_rt``), ``n_faulted``,
    ``n_rejected``, ``clip_frac``, ``fallback`` (faults or a defended
    aggregator), ``n_retx``, ``n_outage``, ``goodput_frac``, ``e_retx``
    (``link_rt``) and ``bits``, ``e_saved`` (``quant_rt``).

    ``keys`` is ``seed_keys(base)`` or the reference's dict ``(fade=...,
    sample=..., ctrl=..., harvest=..., fault=..., link=...)`` (unused
    streams may be left out); ``astate``, ``fstate``, ``lstate`` are None
    where their paths are off. The runtime arguments are the port's own
    (``_AsyncRuntime``, ``_FaultsRuntime``, ``_LinkRuntime``,
    ``_QuantRuntime``, the aggregator, and ``physics`` when any path is on),
    as ``FederatedTrainer`` builds them.

    PyTorch runs eagerly: the rounds are a Python loop, one after another.
    ``unroll`` (the reference's ``lax.scan`` unroll factor) therefore
    changes nothing and must be at least 1; ``n_rounds`` is a plain int.
    With ``mesh`` (a clients mesh, ``repro_torch.sharding``), ``mesh_axis``
    names its client axis as the trainer's does: ``data`` holds this
    rank's rows of the ghost-padded stack (``shard_client_data``),
    ``weights`` the whole padded axis, ``n_real`` the true client count;
    the rank samples, trains and sparsifies its rows, and the outputs are
    replicated. ``use_pallas`` is taken for the reference's signature: the
    tensors' device picks the route."""
    del use_pallas
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    n_pad = int(weights.shape[0])
    n_real = n_real if n_real is not None else n_pad
    shard = _ClientShard.of_mesh(mesh, mesh_axis, n_real, n_pad)
    core = _make_round_core(controller=controller, spec=spec, weights=weights,
                            server_lr=server_lr, block=block, shard=shard,
                            async_rt=async_rt, fault_rt=fault_rt,
                            aggregator=aggregator, link_rt=link_rt,
                            quant_rt=quant_rt, physics=physics)
    pathloss = torch.as_tensor(pathloss, dtype=torch.float32)

    def scan_fn(params, ctrl_state, battery, astate, fstate, lstate, data,
                keys, start_round, last_round, eval_every, n_rounds: int):
        if isinstance(keys, dict):
            keys = RoundKeys(**{f: keys.get(f) for f in RoundKeys._fields})
        dev = battery.device if battery is not None else P.device
        outs = []
        with torch.no_grad():
            for r in range(int(start_round), int(start_round) + n_rounds):
                h = round_gains(keys.fade, pathloss, r, rayleigh,
                                mobility=mobility).to(dev)
                ckeys = client_sample_keys(keys.sample, r, n_real, n_pad)
                ckeys = ckeys[shard.i0:shard.i0 + shard.n_local]
                batches = sample_client_batches(data.arrays, data.lengths,
                                                ckeys, local_steps, batch)
                updates, u_norms, losses = client_step(params, batches)
                (params, dec, ctrl_state, battery, astate, fstate, lstate,
                 extras) = core(params, updates, u_norms, h, P, r,
                                prng.fold_in(keys.ctrl, r), ctrl_state,
                                battery, astate, keys.harvest, fstate,
                                keys.fault, lstate, keys.link)
                losses = shard.gather(losses)
                acc = (eval_fn(params).to(torch.float32)
                       if r % eval_every == 0 or r == last_round
                       else torch.tensor(float("nan"), device=dev))
                outs.append(dict(x=dec.x, gamma=dec.gamma,
                                 bandwidth=dec.bandwidth, energy=dec.energy,
                                 accuracy=acc, loss=torch.mean(losses),
                                 battery=battery, **extras))
        stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return params, ctrl_state, battery, astate, fstate, lstate, stacked

    return scan_fn


class FederatedTrainer:
    """Drives FL rounds for a given controller.

    ``model_loss(params, batch) -> (loss, aux)`` is a function of a params
    dict (e.g. ``repro_torch.models.cnn_loss(model)``); ``model_params``
    maps dotted names to tensors in the JAX package's layout (e.g.
    ``dict(model.named_parameters())`` or
    ``repro_torch.convert.params_from_numpy``); ``eval_fn(params)`` returns
    the accuracy as a scalar tensor. ``client_datasets`` are
    ``ClientDataset``s or dicts of numpy arrays.

    ``device=None`` runs on the GPU and raises when none is visible;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.

    ``device_profile``: a ``core.energy.DeviceProfile`` (or a kind string
    such as "tiered") adds the per-round computation energy — priced by
    the controller and charged every round — and the batteries' starting
    charge; depleted clients are masked unselectable. A profile carrying
    default widths (``bits``) turns the quantized path on.

    ``link_cfg``: a ``core.link.LinkConfig`` makes the uplink lossy —
    Gilbert-Elliott burst interference on the physics channel, per-attempt
    Rayleigh outages with bounded HARQ (each attempt charging its real
    energy and airtime, with a backoff slot before each retry; exhausted
    clients dropped from the aggregate) and, with ``price_outage``, the
    expected attempt count in the solver's pricing. It fills the
    ``n_retx``/``n_outage``/``goodput_frac``/``e_retx`` log lanes. ``None``
    or a disabled config keeps the legacy round.

    A joint ``fe_cfg.bits_grid`` (anything but ``(32.0,)``) lets the
    solver pick a width per client; the selected updates are quantized at
    it after sparsification (``compression.quantize_rows``), every comm
    charge uses the payload gamma ``gamma*bits/32``, and the logs gain
    ``bits`` and ``e_saved``.

    ``async_cfg``: a ``core.rounds.AsyncConfig`` makes rounds timed —
    deadline-infeasible clients are masked out, late clients are dropped
    from the aggregate with partial energy (or, with ``staleness``, kept
    in the carried stale buffer and folded in later with the
    ``(1 + tau)^-a`` discount), batteries recharge by the harvesting draw,
    and the logs gain ``t_round``/``made``/``n_late``/``n_stale``. With the
    link's outages on, a client's timeline is its whole retry sequence.

    ``fault_cfg``: a ``core.faults.FaultConfig`` injects (seed,
    round)-pure faults — mid-round crashes with partial energy, corrupted
    payloads, channel-estimate error and open-population churn (arriving
    clients get fresh controller state through ``reset_clients``).
    ``defense``: a ``core.faults.DefenseConfig`` routes aggregation through
    the defended aggregator (finite screen, norm clip against a streaming
    quantile, optional trimmed mean). Either adds the
    ``n_faulted``/``n_rejected``/``clip_frac``/``fallback`` log lanes and
    the whole-round guard: a non-finite aggregate is rejected (params
    unchanged, every participant counted rejected). Disabled configs keep
    the legacy round.

    ``mesh``: a ``DeviceMesh`` on the trainer's device type — the 1-D
    ``clients`` mesh (``repro_torch.sharding.make_clients_mesh``) or the
    2-D ``(clusters, clients)`` one (``make_hierarchy_mesh``) — shards the
    client axis over its ranks (cluster-major on the 2-D mesh, whose
    all-reduces run over ``clients`` and then ``clusters``); every rank
    builds the trainer with the same arguments and runs the same rounds.
    Anything but a ``DeviceMesh`` raises ``TypeError``.

    ``controller`` (or its alias ``strategy``) is a registry name or an
    instance; ``fixed_k``, ``eco_gamma`` and ``eco_bandwidth`` set the
    fixed-K baselines' K and EcoRandom's gamma and bandwidth
    (``ControllerContext``).

    ``hierarchy``: a ``core.hierarchy.HierarchyConfig`` switches the
    controller to the sampled decide path when ``sampling_enabled``:
    clients are k-means clustered over channel statistics and device tier,
    each round draws a candidate pool proportional to the fairness deficit
    (cluster-stratified) and the wrapped controller solves on the gathered
    ``[K_pool]`` slice. The sampler key (``fold_in(PRNGKey(seed),
    POOL_STREAM)``) rides in the carry (``HierarchyState.key``), so resumed
    runs replay the same pools; under ``run_sweep`` it is shared by the
    seed lanes, as in the reference. A disabled config leaves the
    controller unwrapped.

    ``mobility``: a ``core.channel.MobilityConfig`` adds the slow (seed,
    round)-pure log-normal pathloss drift to every round's channel draw;
    ``None`` or ``sigma_db = 0`` keeps the static channel.
    """

    def __init__(self, *, model_loss: Callable, model_params: dict,
                 client_datasets, eval_fn: Callable, fl_cfg, fe_cfg, ch_cfg,
                 controller: Union[str, Controller] = "fairenergy",
                 strategy: Optional[str] = None,
                 fixed_k: Optional[int] = None, eco_gamma: float = 0.1,
                 eco_bandwidth: Optional[float] = None,
                 seed: int = 0, device=None, device_profile=None,
                 link_cfg: Optional[LinkConfig] = None, mobility=None,
                 async_cfg: Optional[AsyncConfig] = None,
                 fault_cfg: Optional[FaultConfig] = None,
                 defense: Optional[DefenseConfig] = None,
                 hierarchy=None, mesh=None, mesh_axis: str = CLIENTS_AXIS):
        if strategy is not None:
            controller = strategy
        self.device = resolve_device(device)
        dev = self.device
        for name, value, kind in (("async_cfg", async_cfg, AsyncConfig),
                                  ("fault_cfg", fault_cfg, FaultConfig),
                                  ("defense", defense, DefenseConfig),
                                  ("link_cfg", link_cfg, LinkConfig),
                                  ("hierarchy", hierarchy, HierarchyConfig)):
            if value is not None and not isinstance(value, kind):
                raise TypeError(f"{name} must be a {kind.__name__} instance "
                                f"or None, got {type(value).__name__}")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        if mesh is not None:
            check_clients_mesh(mesh, mesh_axis)
            if mesh.device_type != dev.type:
                raise ValueError(f"the mesh is on {mesh.device_type}, the "
                                 f"trainer on {dev.type}")
        self.loss_fn = model_loss
        self.params = {k: torch.as_tensor(v).detach().to(dev, copy=True)
                       for k, v in model_params.items()}
        self.eval_fn = eval_fn
        self.fl_cfg, self.fe_cfg, self.ch_cfg = fl_cfg, fe_cfg, ch_cfg
        self.n_clients = len(client_datasets)
        if ch_cfg.n_clients != self.n_clients:
            raise ValueError(f"ch_cfg.n_clients={ch_cfg.n_clients} but "
                             f"{self.n_clients} client datasets")
        self.network = WirelessNetwork(ch_cfg, seed=seed,
                                       device_profile=device_profile,
                                       mobility=mobility)
        # normalized by the network: a disabled (sigma_db=0) config is None
        self.mobility = self.network.mobility
        self.device_profile = self.network.device_profile
        self.spec = tree_spec(self.params)
        self.n_params = int(sum(self.spec.sizes))
        self.s_bits = 32.0 * self.n_params
        self.i_bits = float(self.n_params)            # 1-bit/coeff kept-mask
        # per-round computation time and energy from the device profile (a
        # round is local_steps minibatches of local_batch samples); without
        # a profile, the communication-only objective and instant compute
        e_cmp = t_cmp = None
        if self.device_profile is not None:
            samples = fl_cfg.local_steps * fl_cfg.local_batch
            e_cmp = comp_energy(self.device_profile, samples)
            t_cmp = comp_time(self.device_profile, samples)
        ctx = ControllerContext(
            n_clients=self.n_clients, b_tot=ch_cfg.bandwidth_total,
            s_bits=self.s_bits, i_bits=self.i_bits, n0=ch_cfg.noise_density,
            fe_cfg=fe_cfg, fixed_k=fixed_k, eco_gamma=eco_gamma,
            eco_bandwidth=eco_bandwidth, device=dev,
            e_cmp=None if e_cmp is None else tuple(e_cmp.tolist()))
        zeros = torch.zeros(self.n_clients, dtype=torch.float32)
        self._e_cmp = (zeros if e_cmp is None else e_cmp).to(dev)
        self._t_cmp = (zeros if t_cmp is None else t_cmp).to(dev)
        self.physics = _Physics(
            e_cmp=self._e_cmp, t_cmp=self._t_cmp,
            b_tot=float(ch_cfg.bandwidth_total), s_bits=self.s_bits,
            i_bits=self.i_bits, n0=float(ch_cfg.noise_density))
        self.controller = make_controller(controller, ctx)
        self.controller_name = (controller if isinstance(controller, str)
                                else getattr(controller, "name",
                                             type(controller).__name__.lower()))
        # ---- hierarchical control (core.hierarchy): wrap only when the
        # sampled path changes anything, so a disabled config is legacy
        self.hierarchy = hierarchy
        if (hierarchy is not None
                and hierarchy.sampling_enabled(self.n_clients)):
            self.controller = wrap_controller(
                self.controller, hierarchy, ctx,
                pathloss=self.network.pathloss, power=self.network.power,
                base_key=prng.fold_in(prng.PRNGKey(seed), POOL_STREAM),
                seed=seed)
        self.ctrl_state = self.controller.init(self.n_clients)

        self.seed = seed
        # independent streams off one per-seed base key; keys stay on the
        # host, where the [N]-sized hashes are cheapest
        self.keys = seed_keys(prng.PRNGKey(seed))
        self._client_step = make_batched_client_step(model_loss, fl_cfg.lr)
        self._P = torch.as_tensor(self.network.power, dtype=torch.float32,
                                  device=dev)
        self._pathloss = torch.as_tensor(self.network.pathloss,
                                         dtype=torch.float32)
        if mesh is None:
            self._data = stack_client_datasets(client_datasets, dev)
            lengths = self._data.lengths
        else:
            # stack and pad on the host, keep this rank's rows on the device
            data = stack_client_datasets(
                client_datasets, "cpu",
                pad_to_multiple=client_shard_count(mesh, mesh_axis))
            lengths = data.lengths
            local = shard_client_data(data, mesh, mesh_axis)
            self._data = type(local)(
                arrays={k: v.to(dev) for k, v in local.arrays.items()},
                lengths=local.lengths.to(dev))
        # ghost clients have length 0, hence zero aggregation weight;
        # this rank's rows are [i0, i0 + n_local) of the padded axis
        lengths = lengths.cpu().numpy().astype(np.float64)
        self.n_padded = len(lengths)
        self._shard = _ClientShard.of_mesh(mesh, mesh_axis, self.n_clients,
                                           self.n_padded)
        self.n_local, self._i0 = self._shard.n_local, self._shard.i0
        self.weights = lengths / lengths.sum()
        # battery charge carried across rounds: the profile's capacities,
        # unlimited without a profile; every sweep lane starts from _battery0
        self._battery0 = (
            self.device_profile.battery.to(dev, torch.float32, copy=True)
            if self.device_profile is not None
            else torch.full((self.n_clients,), UNLIMITED_J,
                            dtype=torch.float32, device=dev))

        # ---- timed rounds (core.rounds): a disabled config resolves to
        # None, and with it the legacy untimed round
        self.async_cfg = async_cfg
        self._async_rt = self._resolve_async_runtime(async_cfg, ctx)
        self.deadline_s = (self._async_rt.deadline
                           if self._async_rt is not None else float("inf"))
        self._astate0 = (init_async_state(self.n_local, self.n_params, dev)
                         if self._async_rt is not None
                         and self._async_rt.staleness else None)

        # ---- faults and defended aggregation (core.faults)
        self.fault_cfg, self.defense_cfg = fault_cfg, defense
        self.aggregator = make_aggregator(
            "defended" if defense is not None and defense.enabled else "mean",
            defense)
        self._fault_rt = self._resolve_fault_runtime(fault_cfg)
        self._fstate0 = self.aggregator.init(dev)

        # ---- the lossy uplink (core.link)
        self.link_cfg = link_cfg
        self._link_rt = self._resolve_link_runtime(link_cfg)
        self._lstate0 = (init_link_state(self.n_clients, dev)
                         if self._link_rt is not None and self._link_rt.bursty
                         else None)
        # the [N] width a controller without the joint grid transmits at,
        # or None off the quantized path
        self._default_bits = self._resolve_default_bits()
        self._quant_rt = (None if self._default_bits is None
                          else _QuantRuntime(self._default_bits))
        (self._battery, self._astate, self._fstate,
         self._lstate) = self._starting_state()
        # the round body after the client step, shared with the engine
        # factories
        kw = self._engine_kwargs()
        self._core = _make_round_core(
            shard=self._shard, **{k: kw[k] for k in (
                "controller", "spec", "weights", "server_lr", "async_rt",
                "fault_rt", "aggregator", "link_rt", "quant_rt", "physics")})
        self._calibrated = False
        self.history: list[RoundLog] = []

    def _resolve_async_runtime(self, cfg: Optional[AsyncConfig],
                               ctx: ControllerContext):
        """The timed-round runtime, or None when the config is absent or
        disabled: the battery caps, the harvesting rates and the concrete
        deadline (``deadline_q`` resolved against deterministic round-time
        estimates, pure in the trainer's geometry)."""
        if cfg is None or not cfg.enabled:
            return None
        deadline = cfg.deadline_s
        if cfg.deadline_q is not None:
            deadline = resolve_deadline(
                cfg.deadline_q, t_cmp=self._t_cmp.cpu().numpy(),
                P=self.network.power, h=self.network.pathloss,
                b_tot=self.ch_cfg.bandwidth_total, s_bits=self.s_bits,
                i_bits=self.i_bits, n0=self.ch_cfg.noise_density, k=ctx.k)
        rates = (harvest_rates(self.device_profile, self.n_clients,
                               cfg.harvest_j, self.device)
                 if cfg.harvest_j is not None else None)
        return _AsyncRuntime(
            deadline=float(deadline), staleness=cfg.staleness,
            staleness_a=float(cfg.staleness_a), cap=self._battery0.clone(),
            rates=rates,
            gamma_floor=float(getattr(self.fe_cfg, "gamma_min", 0.1) or 0.1))

    @staticmethod
    def _resolve_fault_runtime(cfg: Optional[FaultConfig]):
        """The fault runtime, or None when the config is absent or
        disabled (the legacy fault-free round)."""
        if cfg is None or not cfg.enabled:
            return None
        return _FaultsRuntime(
            crash_rate=float(cfg.crash_rate),
            corrupt_rate=float(cfg.corrupt_rate),
            corrupt_mode=str(cfg.corrupt_mode),
            corrupt_scale=float(cfg.corrupt_scale),
            h_err_std=float(cfg.h_err_std),
            churn_dwell=int(cfg.churn_dwell),
            churn_away=float(cfg.churn_away))

    @staticmethod
    def _resolve_link_runtime(cfg: Optional[LinkConfig]):
        """The link runtime, or None when the config is absent or
        disabled (the legacy lossless round)."""
        if cfg is None or not cfg.enabled:
            return None
        return _LinkRuntime(
            outage=bool(cfg.outage),
            margin=float(10.0 ** (cfg.fade_margin_db / 10.0)),
            max_retx=int(cfg.max_retx), backoff_s=float(cfg.backoff_s),
            bursty=bool(cfg.bursty), burst_p=float(cfg.burst_p),
            burst_q=float(cfg.burst_q),
            noise_rise=1.0 + float(cfg.i_burst_n0),
            observe_burst=bool(cfg.observe_burst),
            price_outage=bool(cfg.price_outage))

    def _resolve_default_bits(self):
        """The per-client fallback width (32 unless the profile carries
        tier widths), or None when neither a joint (gamma, bits) grid nor
        profile default widths below 32 are set (the legacy full-precision
        round)."""
        grid = tuple(float(b) for b in
                     (getattr(self.fe_cfg, "bits_grid", None) or (32.0,)))
        active = grid != (32.0,)
        default_bits = torch.full((self.n_clients,), 32.0,
                                  dtype=torch.float32)
        prof_bits = (self.device_profile.bits
                     if self.device_profile is not None else None)
        if prof_bits is not None and bool((prof_bits < 32.0).any()):
            active = True
            default_bits = prof_bits.to(torch.float32)
        if not active:
            return None
        return default_bits.to(self.device)

    # ------------------------------------------------------------------
    @property
    def strategy(self) -> str:
        """The controller's name (the reference's alias of it)."""
        return self.controller_name

    @property
    def battery(self) -> np.ndarray:
        """[N] current per-client battery charge (J; inf = unlimited)."""
        return self._battery.cpu().numpy()

    @property
    def harvest_key(self) -> torch.Tensor:
        return self.keys.harvest

    @property
    def fault_key(self) -> torch.Tensor:
        return self.keys.fault

    @property
    def carry(self) -> Carry:
        """The trainer's live carry (what ``run_scanned`` continues)."""
        return Carry(self.params, self.ctrl_state, self._battery,
                     self._astate, self._fstate, self._lstate)

    def _store(self, carry: Carry) -> None:
        (self.params, self.ctrl_state, self._battery, self._astate,
         self._fstate, self._lstate) = carry

    def _starting_state(self) -> tuple:
        """Copies of the starting battery, stale buffer, defense and link
        state."""
        copy = lambda st: None if st is None else type(st)(  # noqa: E731
            *[t.clone() for t in st])
        return (self._battery0.clone(), copy(self._astate0),
                copy(self._fstate0), copy(self._lstate0))

    def _fresh_carry(self, ctrl_state) -> Carry:
        """A sweep lane's starting carry: the trainer's current params, the
        given controller state, and the starting state."""
        return Carry({k: v.clone() for k, v in self.params.items()},
                     ctrl_state, *self._starting_state())

    def _engine_kwargs(self) -> dict:
        """The keywords with which ``make_scan_engine`` rebuilds this
        trainer's rounds (the reference trainer's ``_get_scan_engine``);
        ``make_round_engine`` takes its ``controller``, ``spec``,
        ``weights``, ``server_lr``, ``fault_rt``, ``aggregator`` and
        ``physics``."""
        return dict(
            controller=self.controller, spec=self.spec,
            weights=torch.as_tensor(self.weights, dtype=torch.float32,
                                    device=self.device),
            server_lr=self.fl_cfg.server_lr, client_step=self._client_step,
            eval_fn=self.eval_fn, pathloss=self._pathloss, P=self._P,
            rayleigh=self.ch_cfg.rayleigh,
            local_steps=self.fl_cfg.local_steps,
            batch=self.fl_cfg.local_batch, mesh=self.mesh,
            mesh_axis=self.mesh_axis, n_real=self.n_clients,
            async_rt=self._async_rt, fault_rt=self._fault_rt,
            aggregator=self.aggregator, mobility=self.mobility,
            link_rt=self._link_rt, quant_rt=self._quant_rt,
            physics=self.physics)

    def _round_batches(self, r: int, sample_key: torch.Tensor) -> dict:
        """Round-r minibatches [n_local, steps, batch, ...] on the device:
        this rank's rows of the padded client axis."""
        ckeys = client_sample_keys(sample_key, r, self.n_clients,
                                   self.n_padded)
        ckeys = ckeys[self._i0:self._i0 + self.n_local]
        return sample_client_batches(self._data.arrays, self._data.lengths,
                                     ckeys, self.fl_cfg.local_steps,
                                     self.fl_cfg.local_batch)

    def _maybe_calibrate(self, r: int):
        """One-shot eta_auto calibration from round-r observations, then a
        fresh controller state so the calibrated eta reaches the solver.
        Skipped after a checkpoint restore, whose controller state already
        carries the calibrated eta (re-initing would wipe its duals)."""
        if self._calibrated:
            return
        if not getattr(self.controller, "needs_calibration", False):
            return
        with torch.no_grad():
            _, u_norms, _ = self._client_step(
                self.params, self._round_batches(r, self.keys.sample))
            u_norms = self._shard.gather(u_norms)
        # the reference calibrates on its eager gains(r), whose drift is
        # associated otherwise than the scanned round's (C-20)
        self.controller.calibrate(u_norms.cpu().numpy(),
                                  self.network.calibration_gains(r),
                                  self.network.power)
        self.ctrl_state = self.controller.init(self.n_clients)
        self._calibrated = True

    @torch.no_grad()
    def _round(self, r: int, evaluate: bool, keys: RoundKeys,
               carry: Carry) -> tuple[dict, Carry]:
        """One round of the lane with ``keys`` from ``carry``: fading,
        minibatches and the client step, then the round body
        (``_make_round_core``: decide, hard mask, energy and time
        accounting, battery debit, sparsify, quantize, corrupt, aggregate,
        stale fold, apply), then eval — in the reference's order. Returns
        the round's outputs as device tensors and the next carry; the
        trainer itself is not changed."""
        params, ctrl_state, battery, astate, fstate, lstate = carry
        dev = self.device
        h = round_gains(keys.fade, self._pathloss, r, self.ch_cfg.rayleigh,
                        mobility=self.mobility).to(dev)
        updates, u_norms, losses = self._client_step(
            params, self._round_batches(r, keys.sample))
        (params, dec, ctrl_state, battery, astate, fstate, lstate,
         extras) = self._core(params, updates, u_norms, h, self._P, r,
                              prng.fold_in(keys.ctrl, r), ctrl_state, battery,
                              astate, keys.harvest, fstate, keys.fault,
                              lstate, keys.link)
        losses = self._shard.gather(losses)
        acc = (self.eval_fn(params).to(torch.float32) if evaluate
               else torch.tensor(float("nan"), device=dev))
        out = dict(x=dec.x, gamma=dec.gamma, bandwidth=dec.bandwidth,
                   energy=dec.energy, accuracy=acc,
                   loss=torch.mean(losses), battery=battery, **extras)
        return out, Carry(params, ctrl_state, battery, astate, fstate, lstate)

    @staticmethod
    def _host(outs: list) -> dict:
        """Rounds' outputs stacked on a leading round axis, on the host
        (one copy each)."""
        return {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                for k in outs[0]}

    def _append_logs(self, start: int, outs: list, walls: list) -> None:
        """Materialize one chunk of round outputs (one host copy)."""
        host = self._host(outs)
        timed, faulted = "t_round" in host, "n_faulted" in host
        linked, quanted = "n_retx" in host, "bits" in host
        for i in range(len(outs)):
            x = host["x"][i]
            self.history.append(RoundLog(
                round=start + i, selected=x, gamma=host["gamma"][i],
                bandwidth=host["bandwidth"][i], energy=host["energy"][i],
                accuracy=float(host["accuracy"][i]),
                loss=float(host["loss"][i]), n_selected=int(x.sum()),
                battery=host["battery"][i],
                t_round=float(host["t_round"][i]) if timed else None,
                made=host["made"][i] if timed else None,
                n_late=int(host["n_late"][i]) if timed else None,
                n_stale=int(host["n_stale"][i]) if timed else None,
                n_faulted=int(host["n_faulted"][i]) if faulted else None,
                n_rejected=int(host["n_rejected"][i]) if faulted else None,
                clip_frac=float(host["clip_frac"][i]) if faulted else None,
                fallback=bool(host["fallback"][i]) if faulted else None,
                n_retx=int(host["n_retx"][i]) if linked else None,
                n_outage=int(host["n_outage"][i]) if linked else None,
                goodput_frac=(float(host["goodput_frac"][i]) if linked
                              else None),
                e_retx=float(host["e_retx"][i]) if linked else None,
                bits=host["bits"][i] if quanted else None,
                e_saved=float(host["e_saved"][i]) if quanted else None,
                wall_s=walls[i]))

    def run_round(self, r: int) -> RoundLog:
        """One round with its log — the debug path; it runs the same
        round body as ``run_scanned``."""
        self._maybe_calibrate(r)
        t0 = time.perf_counter()
        out, carry = self._round(r, True, self.keys, self.carry)
        self._store(carry)
        self._append_logs(r, [out], [self._wall(t0)])
        return self.history[-1]

    def run(self, rounds: Optional[int] = None, *, log_every: int = 10,
            verbose: bool = True):
        """``rounds`` rounds of ``run_round`` from round 0, printing every
        ``log_every``-th and the last; returns ``history``."""
        rounds = rounds or self.fl_cfg.rounds
        for r in range(rounds):
            lg = self.run_round(r)
            if verbose and self._i0 == 0 and (r % log_every == 0
                                              or r == rounds - 1):
                print(f"[{self.controller_name}] round {r:4d} "
                      f"acc={lg.accuracy:.4f} sel={lg.n_selected:2d} "
                      f"E={lg.total_energy*1e3:.3f} mJ")
        return self.history

    def _wall(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def run_scanned(self, rounds: Optional[int] = None, *,
                    chunk: Optional[int] = None, eval_every: int = 1,
                    verbose: bool = True, start_round: int = 0,
                    ckpt_dir: Optional[str] = None, ckpt_every: int = 1):
        """Run rounds ``start_round .. rounds - 1``; append to ``history``
        and return it.

        ``chunk`` bounds the rounds whose logs are gathered to the host
        together (default: all); ``eval_every`` strides the accuracy
        evaluation (skipped rounds log ``accuracy=NaN``; the final round
        is always evaluated). All randomness is pure in (seed, round), so
        a second call replays the same batches and channels.

        ``start_round`` resumes mid-trajectory: the carry must already hold
        that round's state (``restore_checkpoint``), and the remaining
        rounds replay bit for bit. With ``ckpt_dir`` the full carry is saved
        (``save_checkpoint``) after every ``ckpt_every``-th chunk and after
        the final round."""
        rounds = rounds or self.fl_cfg.rounds
        chunk = min(chunk or rounds, rounds)
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every} "
                             "(it strides the eval; use a large value to "
                             "evaluate only the final round)")
        if not 0 <= start_round < rounds:
            raise ValueError(f"start_round {start_round} outside "
                             f"[0, {rounds})")
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        self._maybe_calibrate(start_round)
        for ci, s in enumerate(range(start_round, rounds, chunk)):
            n = min(chunk, rounds - s)
            outs, walls = [], []
            for r in range(s, s + n):
                t0 = time.perf_counter()
                out, carry = self._round(
                    r, (r % eval_every == 0) or r == rounds - 1, self.keys,
                    self.carry)
                self._store(carry)
                outs.append(out)
                walls.append(self._wall(t0))
            self._append_logs(s, outs, walls)
            if ckpt_dir is not None and ((ci + 1) % ckpt_every == 0
                                         or s + n >= rounds):
                self.save_checkpoint(ckpt_dir, s + n)
            if verbose and self._i0 == 0:
                lg = self.history[-1]
                print(f"[{self.controller_name}] rounds {s:4d}..{s + n - 1:4d} "
                      f"acc={lg.accuracy:.4f} sel={lg.n_selected:2d} "
                      f"E={lg.total_energy*1e3:.3f} mJ")
        return self.history

    # ------------------------------------------------------- checkpoints ----
    def _carry_tree(self, astate=None) -> dict:
        """The full carry as one tree (what a checkpoint holds), keyed as
        the reference's ``_carry_tree``: params (nested as the JAX
        package's tree), controller state, batteries, the stale buffer
        (``astate``: by default the trainer's, whole), the defense state
        and the link state."""
        return {"params": _nest(self.params), "ctrl_state": self.ctrl_state,
                "battery": self._battery,
                "astate": self._whole_astate() if astate is None else astate,
                "fstate": self._fstate, "lstate": self._lstate}

    def _whole_astate(self):
        """The stale buffer over every (padded) client: under a mesh each
        rank's rows gathered in rank order, as the reference's sharded
        buffer reads back."""
        if self._astate is None or self._shard.group is None:
            return self._astate
        return AsyncState(*[self._shard.gather_rows(t) for t in self._astate])

    def save_checkpoint(self, directory: str, next_round: int) -> str:
        """Persist the carry after round ``next_round - 1``; resuming at
        ``start_round=next_round`` continues the trajectory bit for bit.
        Under a mesh every rank calls it (the stale buffer is gathered)
        and the mesh's first rank writes the file."""
        tree = self._carry_tree()
        path = _ckpt.checkpoint_path(directory, next_round)
        group = self._shard.group
        if group is None or dist.get_rank(group) == 0:
            path = _ckpt.save_checkpoint(
                directory, next_round, tree,
                metadata={"next_round": int(next_round),
                          "seed": int(self.seed),
                          "controller": self.controller_name,
                          "n_history": len(self.history)})
        if group is not None:
            dist.barrier(group=group)
        return path

    def restore_checkpoint(self, path: str) -> int:
        """Load a checkpoint (the port's or the JAX package's) into the
        live carry and return the round to resume from
        (``run_scanned(start_round=...)``); under a mesh each rank keeps
        its rows of the stale buffer. The restored controller state
        already carries any calibrated ``FEParams``, so calibration is
        marked done."""
        like = self._astate
        if like is not None:
            like = AsyncState(*[t.new_zeros((self.n_padded, *t.shape[1:]))
                                for t in like])
        tree = _ckpt.restore_checkpoint(path, self._carry_tree(like))
        meta = _ckpt.load_metadata(path)
        astate = tree["astate"]
        if astate is not None:
            rows = slice(self._i0, self._i0 + self.n_local)
            astate = AsyncState(*[t[rows].clone() for t in astate])
        self._store(Carry(_unnest(tree["params"]), tree["ctrl_state"],
                          tree["battery"], astate, tree["fstate"],
                          tree["lstate"]))
        self._calibrated = True
        return int(meta["next_round"])

    # ------------------------------------------------------------ sweeps ----
    def run_sweep(self, seeds, rounds: Optional[int] = None, *,
                  eval_every: int = 1, configs: Optional[dict] = None) -> dict:
        """Independent runs over seed lanes — and, with ``configs``, over
        ``FEParams`` config lanes — one lane after another.

        Every lane starts from the trainer's *current* params and
        controller state (sweep a fresh trainer for independent-run error
        bars) with the starting battery, stale buffer, defense and link
        state, shares the client shards and geometry, and draws its own
        fading, batches, controller, harvest, fault and link randomness
        from ``seed_keys(PRNGKey(seed))``. A lane of the trainer's own
        seed, swept before any training, therefore equals its
        ``run_scanned`` bit for bit. With ``eta_auto``, eta is calibrated once from this trainer's round 0
        and shared by every lane. ``history``, ``params`` and the live
        carry are left untouched.

        Returns stacked numpy arrays under the reference's keys:
        ``accuracy``/``loss`` [S, R], ``x``/``gamma``/``bandwidth``/
        ``energy``/``battery`` [S, R, N], plus the timed (``t_round``,
        ``made``, ``n_late``, ``n_stale``), fault (``n_faulted``,
        ``n_rejected``, ``clip_frac``, ``fallback``), link (``n_retx``, ...)
        and quantized (``bits``, ``e_saved``) lanes where those paths are
        on. ``configs`` maps ``FEParams`` fields (``eta``, ``rho``,
        ``b_tot``, ...) to equal-length value lists (a single value
        broadcasts): C config lanes, each run over every seed; the arrays
        gain a leading [C] axis and the lanes are echoed under
        ``"configs"``. It needs a controller whose state carries
        ``FEParams`` (fairenergy). Under a mesh every rank runs the same
        lanes in the same order."""
        rounds = rounds or self.fl_cfg.rounds
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        self._maybe_calibrate(0)
        bases = [prng.PRNGKey(int(s)) for s in seeds]
        if configs is None:
            return self._seed_lanes(bases, rounds, eval_every, self.ctrl_state)
        states, echo = self._config_states(configs)
        lanes = [self._seed_lanes(bases, rounds, eval_every, st)
                 for st in states]
        res = {k: np.stack([ln[k] for ln in lanes]) for k in lanes[0]}
        res["configs"] = echo
        return res

    def _seed_lanes(self, bases, rounds: int, eval_every: int,
                    ctrl_state) -> dict:
        """One lane a base key, each from a fresh carry with
        ``ctrl_state``; outputs stacked [S, R, ...] on the host."""
        lanes = []
        for base in bases:
            keys, carry, outs = seed_keys(base), self._fresh_carry(ctrl_state), []
            for r in range(rounds):
                out, carry = self._round(
                    r, (r % eval_every == 0) or r == rounds - 1, keys, carry)
                outs.append(out)
            lanes.append(self._host(outs))
        return {k: np.stack([ln[k] for ln in lanes]) for k in lanes[0]}

    def _config_states(self, configs: dict) -> tuple[list, dict]:
        """Per-lane controller states from ``FEParams`` overrides
        (equal-length or single values), and the post-broadcast echo
        ``{field: [one value a lane]}``; the reference's checks and
        errors."""
        base = self.ctrl_state
        if not isinstance(getattr(base, "params", None), FEParams):
            raise ValueError(
                "config sweep needs a controller whose state carries "
                "FEParams (the fairenergy controller); "
                f"got {type(self.controller).__name__}")
        unknown = set(configs) - set(FEParams._fields)
        if unknown:
            raise KeyError(f"unknown FEParams field(s) {sorted(unknown)}; "
                           f"sweepable: {list(FEParams._fields)}")
        vals = {k: np.atleast_1d(np.asarray(v, np.float32))
                for k, v in configs.items()}
        n_lanes = max(v.shape[0] for v in vals.values())
        for k, v in vals.items():
            if v.shape[0] == 1:
                vals[k] = np.broadcast_to(v, (n_lanes,))
            elif v.shape[0] != n_lanes:
                raise ValueError(f"config {k!r} has {v.shape[0]} values, "
                                 f"expected 1 or {n_lanes}")
        # the 1 Hz rate floor (ControllerContext) must hold on every lane
        b_lo = vals.get("b_min_frac",
                        np.full(n_lanes, float(base.params.b_min_frac)))
        b_tot = vals.get("b_tot", np.full(n_lanes, float(base.params.b_tot)))
        bad = b_lo * b_tot < 1.0
        if bad.any():
            raise ValueError(
                f"config lane(s) {np.nonzero(bad)[0].tolist()} probe "
                "bandwidth below the 1 Hz rate floor "
                "(b_min_frac * b_tot < 1); raise b_min_frac or b_tot")
        dev = base.params.eta.device
        states = [base._replace(params=base.params._replace(
            **{k: torch.tensor(v[i], device=dev) for k, v in vals.items()}))
            for i in range(n_lanes)]
        return states, {k: np.asarray(v).tolist() for k, v in vals.items()}

    # -------------------------------------------------------- statistics ----
    def participation_counts(self) -> np.ndarray:
        return np.sum([lg.selected for lg in self.history], axis=0)

    def energy_per_round(self) -> np.ndarray:
        return np.array([lg.total_energy for lg in self.history])

    def accuracy_curve(self) -> np.ndarray:
        return np.array([lg.accuracy for lg in self.history])

    def energy_to_accuracy(self, target: float) -> float | None:
        cum = 0.0
        for lg in self.history:
            cum += lg.total_energy
            if lg.accuracy >= target:
                return cum
        return None

    def simulated_time(self) -> float:
        """Cumulative simulated wall-clock (s) across the logged rounds
        (``RoundLog.t_round``); untimed rounds count zero."""
        return float(sum(lg.t_round or 0.0 for lg in self.history))

    def wallclock_to_accuracy(self, target: float) -> float | None:
        """Simulated seconds until accuracy first reaches ``target``; None
        if it never does (or the run is untimed)."""
        cum, timed = 0.0, False
        for lg in self.history:
            cum += lg.t_round or 0.0
            timed = timed or lg.t_round is not None
            if timed and lg.accuracy >= target:
                return cum
        return None

    def mean_gamma_selected(self) -> float:
        vals = [g for lg in self.history for g in lg.gamma[lg.selected]]
        return float(np.mean(vals)) if vals else 1.0

    def min_bandwidth_selected(self) -> float:
        vals = [b for lg in self.history for b in lg.bandwidth[lg.selected] if b > 0]
        return float(np.min(vals)) if vals else self.ch_cfg.bandwidth_total
