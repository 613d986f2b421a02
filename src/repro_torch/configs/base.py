"""Config dataclasses of the FL/FairEnergy system (the port's copy).

``ChannelConfig``, ``FairEnergyConfig`` and ``FLConfig`` are copied field
for field from the JAX package, defaults included, so a config built for
one package means the same run in the other. ``ModelConfig``,
``ShapeConfig`` and ``SHAPES`` are copied whole too: the port runs every
model family among them.

``FairEnergyConfig.use_pallas_solver`` stays for field parity and is
ignored here: in the port the tensors' device picks the path (the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int = 0            # 0 => attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0           # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden (0 => d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group: int = 512        # token-group size for capacity dispatch

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # --- RWKV6 ---
    rwkv_head_size: int = 64

    # --- hybrid (zamba2-style): one shared attention block every k layers ---
    attn_every: int = 0

    # --- attention window (None => full causal) ---
    sliding_window: Optional[int] = None
    # window used when a full-attention arch is lowered for long_500k
    long_context_window: int = 8192

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500   # stub frontend output length
    max_target_len: int = 448

    # --- VLM stub frontend ---
    n_vision_tokens: int = 0

    # --- CNN (paper's FMNIST model) ---
    cnn_channels: Tuple[int, ...] = ()
    cnn_dense: int = 0
    input_hw: Tuple[int, int, int] = (28, 28, 1)
    n_classes: int = 10

    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    source: str = ""             # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape: (name, seq_len, global_batch, kind)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ChannelConfig:
    """Wireless uplink parameters (paper Sec. VII)."""
    n_clients: int = 50
    bandwidth_total: float = 10e6          # B_tot = 10 MHz
    power_min: float = 0.1e-3              # 0.1 mW
    power_max: float = 0.3e-3              # 0.3 mW
    noise_density: float = 4e-21           # N0 (W/Hz) — thermal, -174 dBm/Hz
    index_overhead_bits: float = 0.0       # I, set per-model (log2 indices)
    pathloss_exp: float = 3.0
    cell_radius_m: float = 500.0
    rayleigh: bool = True


@dataclass(frozen=True)
class FairEnergyConfig:
    """Controller hyper-parameters (paper Sec. III-VII)."""
    eta: float = 1e-4               # score weight (calibrated: eta*||u|| ~ E scale)
    eta_auto: bool = True           # calibrate eta on round 0 so that
                                    # eta*median(s(0.5)) == median(E(0.5, B_tot/N))
    eta_rel: float = 6.0            # relative benefit multiplier for eta_auto
    rho: float = 0.6                # EMA memory
    pi_min: float = 0.2             # min participation rate
    gamma_min: float = 0.1
    gamma_grid: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
    q0: float = 1.0                 # "initialize q_i^0 sufficiently large"
    alpha_lambda: float = 2e-4      # bandwidth dual step (normalized b units)
    alpha_mu: float = 1e-2          # fairness dual step
    inner_iters: int = 30           # dual ascent iteration cap per round
    gss_tol: float = 1e-3           # relative tol on bandwidth
    gss_max_iters: int = 60
    b_min_frac: float = 1e-4        # per-device min bandwidth fraction for GSS bracket
    bw_solver: str = "newton"       # "newton" (analytic, 3 steps) | "gss" (oracle)
    newton_iters: int = 3           # Newton steps on the SNR stationarity
    use_pallas_solver: bool = False  # field parity only: ignored by the port
    dual_tol: float = 1e-3          # dual-ascent early-exit residual (0 disables)
    solver_fallback: bool = False   # graceful-degradation guard (eco fallback)
    bits_grid: Tuple[float, ...] = (32.0,)  # joint (gamma, bits) grid;
                                            # (32.0,) = gamma only


@dataclass(frozen=True)
class FLConfig:
    rounds: int = 150
    local_steps: int = 1            # 1 => update == gradient (paper)
    local_batch: int = 64
    lr: float = 0.01
    dirichlet_beta: float = 0.3
    seed: int = 0
    target_accuracy: float = 0.80
    server_lr: float = 1.0
