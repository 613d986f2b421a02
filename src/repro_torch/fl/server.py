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
     the masked |D_i|-weighted mean and applied.

This is the port of ``repro.fl.server`` for the synchronous round with its
optional device profile (computation energy and finite batteries,
``device_profile``), lossy uplink (``link_cfg``: burst interference,
outages with bounded HARQ, outage-aware pricing), quantized payloads (a
joint ``FairEnergyConfig.bits_grid`` or profile default widths) and
client-axis sharding over a ``clients`` mesh (``mesh``; see
``repro_torch.sharding``). Async rounds, faults and defense, hierarchy and
mobility raise ``NotImplementedError`` naming their ROADMAP item (A-12,
A-13, A-15). Without a profile, link config, quantization or mesh the
round is the legacy one, step for step.

Under a mesh each rank holds its ``n_local`` rows of the ghost-padded
client stack: it samples, trains, sparsifies, quantizes and partially
aggregates them, all-gathers ``u_norms`` and losses (cut to the real
clients) before anything reads them, runs the controller on the full
replicated ``[N]`` observation, and all-reduces the partial sums (in
float64, ``weighted_sum``, so the aggregate's bits do not depend on the
mesh); params, controller, battery and link state and the logs are
replicated.

The round body runs the reference's steps in its order (``_round``), on
a lane's key streams (``RoundKeys``: fading, controller, sampling and link
keys off one base key) and its carry (``Carry``: params, controller
state, battery, link state). ``run_round``, ``run``, ``run_scanned`` and
``run_sweep`` all drive that one body. PyTorch runs eagerly, so
``run_scanned`` is a loop over rounds that materializes its logs on the
host once per chunk, and ``run_sweep`` runs its seed and config lanes one
after another (the reference's sharded sweep does the same).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import random as prng
from ..core.channel import WirelessNetwork, comm_energy, comm_time, round_gains
from ..core.controllers import (Controller, ControllerContext,
                                RoundObservation, make_controller)
from ..core.energy import UNLIMITED_J, alive_mask, comp_energy
from ..core.fairenergy import FEParams
from ..core.link import (LinkConfig, LinkState, attempt_energy,
                         attempt_outcomes, burst_channel, burst_step,
                         expected_attempts, init_link_state,
                         outage_probability)
from ..core.streams import CTRL_STREAM, LINK_STREAM, SAMPLE_STREAM
from ..data.pipeline import (client_sample_keys, sample_client_batches,
                             stack_client_datasets)
from ..devices import resolve_device
from ..sharding.fl import (CLIENTS_AXIS, check_clients_mesh,
                           client_shard_count, shard_client_data)
from . import compression
from .client import make_batched_client_step
from .updates import tree_spec, unflatten_update

__all__ = ["Carry", "FederatedTrainer", "RoundKeys", "RoundLog", "UNLIMITED_J",
           "resolve_device", "seed_keys"]

# options of the reference's trainer this slice does not bring, and the
# ROADMAP item that brings each
_UNPORTED = {"async_cfg": "A-12", "fault_cfg": "A-13", "defense": "A-13",
             "hierarchy": "A-15"}


# rows of the update matrix widened to float64 at a time by weighted_sum
_SUM_ROWS = 8


def weighted_sum(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``sum_i w[i] * rows[i]`` of fp32 ``w`` [n] and ``rows`` [n, D],
    accumulated in float64 ([D] float64). Each product is exact there and
    each addition rounds at float64's ulp, 2^29 times finer than float32's,
    so two groupings of the terms (one GEMV over all clients on one card,
    or each rank's partial sum and the all-reduce across a clients mesh)
    almost never round to different float32 aggregates: the sharded
    trainer equals one card bit for bit (ROADMAP C-17). The rows are
    widened a few at a time, so no float64 copy of the matrix is made."""
    acc = torch.zeros(rows.shape[1], dtype=torch.float64, device=rows.device)
    for i in range(0, rows.shape[0], _SUM_ROWS):
        acc += w[i:i + _SUM_ROWS].double() @ rows[i:i + _SUM_ROWS].double()
    return acc


class RoundKeys(NamedTuple):
    """One lane's key streams: fading uses the base key itself (folded by
    round), the others ``fold_in(base, STREAM)`` with the JAX package's
    stream tags. Keys stay on the host."""
    fade: torch.Tensor
    ctrl: torch.Tensor
    sample: torch.Tensor
    link: torch.Tensor


def seed_keys(base: torch.Tensor) -> RoundKeys:
    """The key streams of the lane whose base key is ``base``
    (``random.PRNGKey(seed)``), as the reference's ``_seed_keys``."""
    return RoundKeys(fade=base, ctrl=prng.fold_in(base, CTRL_STREAM),
                     sample=prng.fold_in(base, SAMPLE_STREAM),
                     link=prng.fold_in(base, LINK_STREAM))


class Carry(NamedTuple):
    """What one round hands the next."""
    params: dict
    ctrl_state: Any
    battery: torch.Tensor        # [N] J (inf = unlimited)
    lstate: Optional[LinkState]  # None unless the burst chain is on


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
class _LinkRuntime:
    """The link-reliability quantities resolved from a ``LinkConfig``."""
    outage: bool
    margin: float                 # linear fade margin 10^(dB/10)
    max_retx: int
    bursty: bool
    burst_p: float
    burst_q: float
    noise_rise: float             # (N0 + I_burst) / N0 >= 1
    observe_burst: bool
    price_outage: bool


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
    energy, exhausted clients dropped from the aggregate) and, with
    ``price_outage``, the expected attempt count in the solver's pricing.
    It fills the ``n_retx``/``n_outage``/``goodput_frac``/``e_retx`` log
    lanes. ``None`` or a disabled config keeps the legacy round.

    A joint ``fe_cfg.bits_grid`` (anything but ``(32.0,)``) lets the
    solver pick a width per client; the selected updates are quantized at
    it after sparsification (``compression.quantize_rows``), every comm
    charge uses the payload gamma ``gamma*bits/32``, and the logs gain
    ``bits`` and ``e_saved``.

    ``mesh``: a 1-D ``clients`` ``DeviceMesh``
    (``repro_torch.sharding.make_clients_mesh``, on the trainer's device
    type) shards the client axis over its ranks; every rank builds the
    trainer with the same arguments and runs the same rounds. Anything but
    a ``DeviceMesh`` raises ``TypeError``; a 2-D (hierarchy) mesh raises
    ``NotImplementedError`` naming ROADMAP A-15.

    ``controller`` (or its alias ``strategy``) is a registry name or an
    instance; ``fixed_k``, ``eco_gamma`` and ``eco_bandwidth`` set the
    fixed-K baselines' K and EcoRandom's gamma and bandwidth
    (``ControllerContext``).

    ``async_cfg``, ``fault_cfg``, ``defense`` and ``hierarchy`` are not
    ported yet and raise ``NotImplementedError`` naming their ROADMAP item;
    an enabled ``mobility`` config raises in the network.
    """

    def __init__(self, *, model_loss: Callable, model_params: dict,
                 client_datasets, eval_fn: Callable, fl_cfg, fe_cfg, ch_cfg,
                 controller: Union[str, Controller] = "fairenergy",
                 strategy: Optional[str] = None,
                 fixed_k: Optional[int] = None, eco_gamma: float = 0.1,
                 eco_bandwidth: Optional[float] = None,
                 seed: int = 0, device=None, device_profile=None,
                 link_cfg: Optional[LinkConfig] = None, mobility=None,
                 async_cfg=None, fault_cfg=None, defense=None,
                 hierarchy=None, mesh=None, mesh_axis: str = CLIENTS_AXIS):
        if strategy is not None:
            controller = strategy
        self.device = resolve_device(device)
        dev = self.device
        for name, value in (("async_cfg", async_cfg), ("fault_cfg", fault_cfg),
                            ("defense", defense), ("hierarchy", hierarchy)):
            if value is not None:
                raise NotImplementedError(
                    f"FederatedTrainer({name}=...) is not ported yet: "
                    f"ROADMAP {_UNPORTED[name]}")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self._group = None
        if mesh is not None:
            check_clients_mesh(mesh, mesh_axis)
            if mesh.device_type != dev.type:
                raise ValueError(f"the mesh is on {mesh.device_type}, the "
                                 f"trainer on {dev.type}")
            self._group = mesh.get_group(mesh_axis)
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
        self.device_profile = self.network.device_profile
        self.spec = tree_spec(self.params)
        self.n_params = int(sum(self.spec.sizes))
        self.s_bits = 32.0 * self.n_params
        self.i_bits = float(self.n_params)            # 1-bit/coeff kept-mask
        # per-round computation energy from the device profile (a round is
        # local_steps minibatches of local_batch samples); None keeps the
        # communication-only objective
        e_cmp = None
        if self.device_profile is not None:
            samples = fl_cfg.local_steps * fl_cfg.local_batch
            e_cmp = comp_energy(self.device_profile, samples)
        ctx = ControllerContext(
            n_clients=self.n_clients, b_tot=ch_cfg.bandwidth_total,
            s_bits=self.s_bits, i_bits=self.i_bits, n0=ch_cfg.noise_density,
            fe_cfg=fe_cfg, fixed_k=fixed_k, eco_gamma=eco_gamma,
            eco_bandwidth=eco_bandwidth, device=dev,
            e_cmp=None if e_cmp is None else tuple(e_cmp.tolist()))
        self._e_cmp = (torch.zeros(self.n_clients, dtype=torch.float32)
                       if e_cmp is None else e_cmp).to(dev)
        self.controller = make_controller(controller, ctx)
        self.controller_name = (controller if isinstance(controller, str)
                                else getattr(controller, "name",
                                             type(controller).__name__.lower()))
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
        self.n_local = self._data.n_clients
        self._i0 = (0 if mesh is None
                    else mesh.get_local_rank(mesh_axis) * self.n_local)
        self.weights = lengths / lengths.sum()
        self._weights = torch.as_tensor(
            self.weights[self._i0:self._i0 + self.n_local],
            dtype=torch.float32, device=dev)
        # battery charge carried across rounds: the profile's capacities,
        # unlimited without a profile; every sweep lane starts from _battery0
        self._battery0 = (
            self.device_profile.battery.to(dev, torch.float32, copy=True)
            if self.device_profile is not None
            else torch.full((self.n_clients,), UNLIMITED_J,
                            dtype=torch.float32, device=dev))
        self._battery = self._battery0.clone()

        if link_cfg is not None and not isinstance(link_cfg, LinkConfig):
            raise TypeError(f"link_cfg must be a LinkConfig or None, got "
                            f"{type(link_cfg).__name__}")
        self.link_cfg = link_cfg
        self._link_rt = self._resolve_link_runtime(link_cfg)
        self._lstate0 = (init_link_state(self.n_clients, dev)
                         if self._link_rt is not None and self._link_rt.bursty
                         else None)
        self._lstate = self._lstate0
        # [N] width a controller without the joint grid transmits at, or
        # None off the quantized path
        self._default_bits = self._resolve_default_bits()
        self._calibrated = False
        self.history: list[RoundLog] = []

    def _resolve_link_runtime(self, cfg: Optional[LinkConfig]):
        """The link runtime, or None when the config is absent or
        disabled (the legacy lossless round)."""
        if cfg is None or not cfg.enabled:
            return None
        return _LinkRuntime(
            outage=bool(cfg.outage),
            margin=float(10.0 ** (cfg.fade_margin_db / 10.0)),
            max_retx=int(cfg.max_retx),
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
    def carry(self) -> Carry:
        """The trainer's live carry (what ``run_scanned`` continues)."""
        return Carry(self.params, self.ctrl_state, self._battery, self._lstate)

    def _store(self, carry: Carry) -> None:
        (self.params, self.ctrl_state, self._battery,
         self._lstate) = carry

    def _fresh_carry(self, ctrl_state) -> Carry:
        """A sweep lane's starting carry: the trainer's current params, the
        given controller state, and the starting battery and link state."""
        return Carry({k: v.clone() for k, v in self.params.items()},
                     ctrl_state, self._battery0.clone(), self._lstate0)

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
        fresh controller state so the calibrated eta reaches the solver."""
        if self._calibrated:
            return
        if not getattr(self.controller, "needs_calibration", False):
            return
        with torch.no_grad():
            _, u_norms, _ = self._client_step(
                self.params, self._round_batches(r, self.keys.sample))
            u_norms = self._gather(u_norms)
        self.controller.calibrate(u_norms.cpu().numpy(),
                                  self.network.gains(r), self.network.power)
        self.ctrl_state = self.controller.init(self.n_clients)
        self._calibrated = True

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """The [N] real-client vector from every rank's [n_local] rows
        (identity without a mesh)."""
        if self._group is None:
            return local
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self._group))]
        dist.all_gather(parts, local.contiguous(), group=self._group)
        return torch.cat(parts)[:self.n_clients]

    def _local(self, vec: torch.Tensor, fill) -> torch.Tensor:
        """This rank's rows of an [N] vector, ghost rows taking ``fill``
        (identity without a mesh)."""
        if self._group is None:
            return vec
        pad = vec.new_full((self.n_padded - self.n_clients,), fill)
        return torch.cat([vec, pad])[self._i0:self._i0 + self.n_local]

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self._group is not None:
            dist.all_reduce(t, group=self._group)
        return t

    @torch.no_grad()
    def _round(self, r: int, evaluate: bool, keys: RoundKeys,
               carry: Carry) -> tuple[dict, Carry]:
        """One round of the lane with ``keys`` from ``carry``: observe,
        decide, hard mask, energy accounting, battery debit, sparsify,
        quantize, weighted mean, apply, eval — in the reference's order.
        Returns the round's outputs as device tensors and the next carry;
        the trainer itself is not changed."""
        params, ctrl_state, battery, lstate = carry
        link, default_bits = self._link_rt, self._default_bits
        quant = default_bits is not None
        # the trainer's own B_tot, as the reference's round body takes it,
        # under a config lane too (the lane's rides in the controller
        # state): it only prices the unselected rows, which are masked
        b_tot = float(self.ch_cfg.bandwidth_total)
        n0 = float(self.ch_cfg.noise_density)
        s_bits, i_bits, e_cmp = self.s_bits, self.i_bits, self._e_cmp
        link_out = link is not None and link.outage
        link_burst = link is not None and link.bursty
        h = round_gains(keys.fade, self._pathloss, r,
                        self.ch_cfg.rayleigh).to(self.device)
        updates, u_norms, losses = self._client_step(
            params, self._round_batches(r, keys.sample))
        # the controller sees the real clients' [N] observation in every
        # layout: gather before any use, ghosts cut off
        u_norms, losses = self._gather(u_norms), self._gather(losses)
        P = self._P
        if link_burst:
            # one Gilbert-Elliott transition a round; the burst derates
            # the physics channel (a raised noise floor is a scaled gain)
            burst = burst_step(keys.link, r, lstate.burst, link.burst_p,
                               link.burst_q)
            lstate = LinkState(burst=burst)
            h_phys = burst_channel(h, burst, link.noise_rise)
        else:
            h_phys = h
        # the controller's channel belief: the quiet-state channel unless
        # it observes the burst; the transmission realizes on h_phys
        h_obs = h_phys if (link_burst and link.observe_burst) else h
        h = h_phys
        alive = alive_mask(battery)
        p_out = e_scale = None
        if link_out:
            # per-attempt outage at the decided operating point: the belief
            # sets the design SNR, the physics the realized fade mean; a
            # per-client scalar, priceable before the decision
            p_out = outage_probability(h_obs, h, link.margin)
            if link.price_outage:
                e_scale = expected_attempts(p_out)
        obs = RoundObservation(u_norms=u_norms, h=h_obs, P=P, round=r,
                               key=prng.fold_in(keys.ctrl, r), alive=alive,
                               e_scale=e_scale)
        dec, ctrl_state = self.controller.decide(obs, ctrl_state)
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
            bits_dec = dec.bits if dec.bits is not None else default_bits
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

        if link is None:
            # debit the round's spend; charge floors at 0 (inf stays inf)
            battery = torch.clamp(battery - dec.energy, min=0.0)
        elif link_burst and not link_out:
            # burst-only: the controller priced the quiet channel, the
            # transmission pays the physics one (b/gamma guards keep the
            # unselected lanes finite)
            b_safe = torch.where(dec.x, dec.bandwidth, b_tot)
            g_safe = torch.where(dec.x, dec.gamma, 1.0)
            dec = dec._replace(energy=xf_sel * (
                comm_energy(pay(g_safe), b_safe, P, h, s_bits, i_bits, n0)
                + e_cmp))
        delivered = None
        if link_out:
            # bounded HARQ: each attempt a full airtime of the decided
            # allocation; the realized cost replaces the priced energy
            b_safe = torch.where(dec.x, dec.bandwidth, b_tot)
            g_safe = torch.where(dec.x, dec.gamma, 1.0)
            t1 = comm_time(pay(g_safe), b_safe, P, h, s_bits, i_bits, n0)
            attempts, delivered = attempt_outcomes(keys.link, r, p_out,
                                                   link.max_retx)
            attempts_f = attempts.to(torch.float32)
            e_retx_vec = xf_sel * (attempts_f - 1.0) * P * t1
            dec = dec._replace(energy=xf_sel * (
                attempt_energy(attempts_f, t1, P) + e_cmp))
            lost = dec.x & ~delivered
        if link is not None:
            # the deferred debit, after the link accounting
            battery = torch.clamp(battery - dec.energy, min=0.0)
        # a retx-exhausted update never decodes: it never enters the
        # aggregate (its energy and fairness effects landed above)
        part = dec.x if delivered is None else dec.x & delivered
        # unselected rows carry zero weight; gamma=1 lets them copy through.
        # Sparsify, quantize and the partial aggregate run on this rank's
        # rows (ghost rows: weight 0, gamma 1, 32 bits); the sums are
        # all-reduced
        gamma = torch.where(dec.x, torch.clamp(dec.gamma, 1e-6, 1.0), 1.0)
        sparse = compression.batch_block_topk(updates,
                                              self._local(gamma, 1.0))
        if quant:
            # client-side quantization of the sparse payload at the
            # transmitted width, dequantized right back
            sparse = compression.quantize_rows(sparse,
                                               self._local(bits_w, 32.0))
        w = self._local(part.to(torch.float32), 0.0) * self._weights
        partial = self._all_reduce(weighted_sum(w, sparse))
        wsum = self._all_reduce(torch.sum(w.double()))
        agg = (partial / torch.clamp(wsum, min=1e-12)).to(torch.float32)
        agg = torch.where(wsum > 0.0, agg * self.fl_cfg.server_lr, 0.0)
        delta = unflatten_update(agg, self.spec)
        params = {k: p + delta[k].to(p.dtype) for k, p in params.items()}
        acc = (self.eval_fn(params).to(torch.float32) if evaluate
               else torch.tensor(float("nan"), device=self.device))
        out = dict(x=dec.x, gamma=dec.gamma, bandwidth=dec.bandwidth,
                   energy=dec.energy, accuracy=acc,
                   loss=torch.mean(losses), battery=battery)
        if quant:
            # e_saved: the same allocation at a 32-bit payload minus the
            # realized single-attempt quantized charge
            b_q = torch.where(dec.x, dec.bandwidth, b_tot)
            g_q = torch.where(dec.x, dec.gamma, 1.0)
            de = (comm_energy(g_q, b_q, P, h, s_bits, i_bits, n0)
                  - comm_energy(pay(g_q), b_q, P, h, s_bits, i_bits, n0))
            out.update(bits=torch.where(dec.x, bits_w, 0.0),
                       e_saved=torch.sum(xf_sel * de))
        if link_out:
            # goodput is link-layer: only exhausted payloads are dead air
            d_bits = pay(g_safe) * s_bits + i_bits
            tx_bits = torch.sum(xf_sel * attempts_f * d_bits)
            ok_bits = torch.sum(torch.where(dec.x & delivered, d_bits, 0.0))
            out.update(
                n_retx=torch.sum(xf_sel * (attempts_f - 1.0)).to(torch.int32),
                n_outage=torch.sum(lost.to(torch.int32)),
                goodput_frac=torch.where(
                    tx_bits > 0.0, ok_bits / torch.clamp(tx_bits, min=1e-30),
                    1.0),
                e_retx=torch.sum(xf_sel * e_retx_vec))
        elif link is not None:
            # burst-only: one lossless attempt per selection
            zero_i = torch.zeros((), dtype=torch.int32, device=self.device)
            out.update(n_retx=zero_i, n_outage=zero_i,
                       goodput_frac=torch.ones((), device=self.device),
                       e_retx=torch.zeros((), device=self.device))
        return out, Carry(params, ctrl_state, battery, lstate)

    @staticmethod
    def _host(outs: list) -> dict:
        """Rounds' outputs stacked on a leading round axis, on the host
        (one copy each)."""
        return {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                for k in outs[0]}

    def _append_logs(self, start: int, outs: list, walls: list) -> None:
        """Materialize one chunk of round outputs (one host copy)."""
        host = self._host(outs)
        linked, quanted = "n_retx" in host, "bits" in host
        for i in range(len(outs)):
            x = host["x"][i]
            self.history.append(RoundLog(
                round=start + i, selected=x, gamma=host["gamma"][i],
                bandwidth=host["bandwidth"][i], energy=host["energy"][i],
                accuracy=float(host["accuracy"][i]),
                loss=float(host["loss"][i]), n_selected=int(x.sum()),
                battery=host["battery"][i],
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
                    verbose: bool = True):
        """Run ``rounds`` FL rounds from round 0; append to ``history``
        and return it.

        ``chunk`` bounds the rounds whose logs are gathered to the host
        together (default: all); ``eval_every`` strides the accuracy
        evaluation (skipped rounds log ``accuracy=NaN``; the final round
        is always evaluated). All randomness is pure in (seed, round), so
        a second call replays the same batches and channels."""
        rounds = rounds or self.fl_cfg.rounds
        chunk = min(chunk or rounds, rounds)
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every} "
                             "(it strides the eval; use a large value to "
                             "evaluate only the final round)")
        self._maybe_calibrate(0)
        for s in range(0, rounds, chunk):
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
            if verbose and self._i0 == 0:
                lg = self.history[-1]
                print(f"[{self.controller_name}] rounds {s:4d}..{s + n - 1:4d} "
                      f"acc={lg.accuracy:.4f} sel={lg.n_selected:2d} "
                      f"E={lg.total_energy*1e3:.3f} mJ")
        return self.history

    # ------------------------------------------------------------ sweeps ----
    def run_sweep(self, seeds, rounds: Optional[int] = None, *,
                  eval_every: int = 1, configs: Optional[dict] = None) -> dict:
        """Independent runs over seed lanes — and, with ``configs``, over
        ``FEParams`` config lanes — one lane after another.

        Every lane starts from the trainer's *current* params and
        controller state (sweep a fresh trainer for independent-run error
        bars) with the starting battery and link state, shares the client
        shards and geometry, and draws its own fading, batches, controller
        and link randomness from ``seed_keys(PRNGKey(seed))``. A lane of
        the trainer's own seed, swept before any training, therefore
        equals its ``run_scanned`` bit for bit. With
        ``eta_auto``, eta is calibrated once from this trainer's round 0
        and shared by every lane. ``history``, ``params`` and the live
        carry are left untouched.

        Returns stacked numpy arrays under the reference's keys:
        ``accuracy``/``loss`` [S, R], ``x``/``gamma``/``bandwidth``/
        ``energy``/``battery`` [S, R, N], plus the link (``n_retx``, ...)
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

    def mean_gamma_selected(self) -> float:
        vals = [g for lg in self.history for g in lg.gamma[lg.selected]]
        return float(np.mean(vals)) if vals else 1.0

    def min_bandwidth_selected(self) -> float:
        vals = [b for lg in self.history for b in lg.bandwidth[lg.selected] if b > 0]
        return float(np.min(vals)) if vals else self.ch_cfg.bandwidth_total
