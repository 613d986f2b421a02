"""Plain PyTorch versions of the flash-attention kernel and its gradient.

* ``attention_ref``: direct softmax(QK^T / sqrt(D)) V with causal /
  sliding-window masks in fp32 — a port of
  ``repro.kernels.flash_attention.ref.attention_ref``. The serve path's
  plain version: the CPU tests run it, and ``chip_smoke.py`` holds the
  CUDA kernels against it.
* ``flash_fwd_ref``: the JAX package's chunked online-softmax forward
  (``repro.models.attention._flash_fwd_impl``), which also returns the
  log-sum-exp of each query row's scaled scores; the training path's
  forward on CPU tensors and the plain version of the kernels' lse output.
* ``flash_bwd_ref``: that package's blockwise recompute backward
  (``_flash_core_bwd``, FlashAttention-2 style, plain JAX there), the
  gradient of both forwards on every device.

The chunked functions keep the JAX package's layout of the log-sum-exp,
``[B, KV, G, Sq]`` fp32 (query head h = kv * G + g), and its chunks of
1024 rows and keys.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
Q_CHUNK = 1024
KV_CHUNK = 1024


def chunk_of(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (the JAX package's
    ``_chunk_of``)."""
    c = min(target, S)
    while c > 1 and S % c:
        c -= 1
    return c


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k/v: [B,Skv,KV,D] -> [B,Sq,H,D] in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / (D ** 0.5)
    qp = torch.arange(Sq, device=q.device)
    kp = torch.arange(Skv, device=q.device)
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= qp[:, None] - kp[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _block_mask(q0: int, qc: int, k0: int, kc: int, causal: bool,
                window: int | None, device) -> torch.Tensor:
    qpos = q0 + torch.arange(qc, device=device)
    kpos = k0 + torch.arange(kc, device=device)
    mask = torch.ones(qc, kc, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _chunks(q: torch.Tensor, k: torch.Tensor):
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qc, kc = chunk_of(Sq, Q_CHUNK), chunk_of(Skv, KV_CHUNK)
    return B, Sq, H, D, Skv, KV, H // KV, qc, kc, 1.0 / float(D) ** 0.5


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [B,Sq,H,D]; k/v: [B,Skv,KV,D] -> (out [B,Sq,H,D] in v's dtype,
    lse [B,KV,G,Sq] fp32). For each chunk of query rows, an online softmax
    over the chunks of keys in fp32: scores ``(q k) * scale``, masked to
    -1e30, running max m, sum l and accumulator, one rescale a chunk;
    ``out = acc / max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))``."""
    B, Sq, H, D, Skv, KV, G, qc, kc, scale = _chunks(q, k)
    qg = q.reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, Sq, qc):
        q_blk = qg[:, q0:q0 + qc].float()
        m = torch.full((B, KV, G, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, qc), device=q.device)
        acc = torch.zeros((B, KV, G, qc, D), device=q.device)
        for k0 in range(0, Skv, kc):
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kf[:, k0:k0 + kc]) * scale
            s = torch.where(_block_mask(q0, qc, k0, kc, causal, window, q.device),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, k0:k0 + kc])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append((acc / l_safe[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(l_safe))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D).to(v.dtype)
    return out, torch.cat(lses, dim=-1)


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of the flash forward from its saved (q, k, v, out,
    lse): ``delta = rowsum(dout * out)``, then for each query chunk and
    key chunk in order, in fp32, the probabilities recomputed as
    ``exp(s - lse)``, ``dv += p^T dout``, ``ds = p (dout v^T - delta)
    scale``, ``dq += ds k`` and ``dk += ds^T q``. Masked blocks are
    computed too (their p is 0), as in the JAX package. Returns (dq, dk,
    dv) in the inputs' types."""
    B, Sq, H, D, Skv, KV, G, qc, kc, scale = _chunks(q, k)
    qg = q.reshape(B, Sq, KV, G, D)
    dog = dout.reshape(B, Sq, KV, G, D)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dog.float(),
                         out.reshape(B, Sq, KV, G, D).float())
    kf, vf = k.float(), v.float()
    dk = torch.zeros((B, Skv, KV, D), device=q.device)
    dv = torch.zeros((B, Skv, KV, D), device=q.device)
    dqs = []
    for q0 in range(0, Sq, qc):
        q_blk = qg[:, q0:q0 + qc].float()
        do_blk = dog[:, q0:q0 + qc].float()
        lse_blk = lse[..., q0:q0 + qc]
        dl_blk = delta[..., q0:q0 + qc]
        dq = torch.zeros((B, qc, KV, G, D), device=q.device)
        for k0 in range(0, Skv, kc):
            k_blk, v_blk = kf[:, k0:k0 + kc], vf[:, k0:k0 + kc]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            s = torch.where(_block_mask(q0, qc, k0, kc, causal, window, q.device),
                            s, NEG_INF)
            p = torch.exp(s - lse_blk[..., None])
            dv[:, k0:k0 + kc] += torch.einsum("bkgqs,bqkgd->bskd", p, do_blk)
            dp = torch.einsum("bqkgd,bskd->bkgqs", do_blk, v_blk)
            ds = p * (dp - dl_blk[..., None]) * scale
            dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, k_blk)
            dk[:, k0:k0 + kc] += torch.einsum("bkgqs,bqkgd->bskd", ds, q_blk)
        dqs.append(dq)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, D).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
