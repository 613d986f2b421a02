"""CPU models of the two flash kernels' arithmetic at any head dim, for the
port's tests (no JAX here).

``sm90_model`` is the tensor-core kernel (``csrc/flash_sm90.cuh``) for bf16
and fp16: CTAs of 128 query rows in two warpgroups of 64, key tiles of BK
from the CTA's first visible tile, a warpgroup skipping the tiles wholly
above its diagonal or before its window; S in fp32 times 1/sqrt(D); masked
scores -1e30, keys past Skv -inf; online softmax with exp2((s - m) log2 e);
l sums the fp32 P, and O += P V with P rounded to the input's type; o = O /
max(l, 1e-30) in that type. Up to 256 the kernel computes on DP = D rounded
up to 32 columns (BK 128 at DP <= 64, 64 up to 160, 32 above); above 256 on
``ops.column_groups(D)``, each group (one CTA) running the same softmax on
the same S and accumulating only its GW columns of O. By ``ops.sm90_route``:
on the cluster kernel (up to ``ops.SM90_CLUSTER_MAX``) each group's partial
S over its own GW columns is a chain of 16-column wgmma k-steps on one
accumulator, and the partials are added in the order g = 0, 1, ... (BK
32); on the wide kernel above it every group sums S over all of D in
chunks of 64 columns in order (BK 64 at GW = 160, 32 above).

``simt_model`` is the fp32 wide SIMT kernel (``csrc/flash_simt.cuh``, which
runs above D = 2,048; its arithmetic is the same at any D above 256):
32-row query tiles, key tiles of 32, q times 1/sqrt(D) in fp32, each score
a chain of fmaf over d in order, taken through chunks of 128 columns; a
row's max over the tile and one rescale a tile; l as 8 shares added in the
shuffles' tree; O's group columns updated by a chain of fmaf over the
tile's keys.

``tf32_model`` is the fp32 kernel on the tensor cores in 3xTF32
(``csrc/flash_tf32.cuh``), which runs head dims 129 to 2,048: 128-row query
tiles, key tiles of 32 from the CTA's first visible tile; q times
1/sqrt(D) in fp32; each operand x split into hi (x with its low 13 bits
cleared) and lo = x - hi, lo read by the tensor core through its top 19
bits (``tf32_split``); for every 8 columns of the summed index three
products chained on an fp32 accumulator, lo hi, hi lo, hi hi, each the
exact sum of 8 exact products and the accumulator rounded toward zero
(``_mma``: one mma.sync as the card's tensor core rounds it, to within
an ulp); a score's chain runs over one 32-column box on a fresh
accumulator, the boxes added in float32, and a key tile's P V likewise
added to O. Up to 256 the computed width is D
rounded up to 32; above, each column group (one CTA of a cluster) sums
its own columns' partial scores, and every group adds the partials in the
order g = 0, 1, ... before its softmax; masked
scores -1e30, keys past Skv -inf, exp, l as four shares of keys 8 j + 2 t
and 8 j + 2 t + 1 (t < 4) added in the shuffles' tree; P split as above
for O += P V.

All record each group's running max and sum (``record``), which the
kernels rely on being equal across groups: group 0 alone writes lse.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops

LOG2E = 1.4426950408889634


def _padded(t: torch.Tensor, cols: int, rows: int = 0) -> torch.Tensor:
    """[B, S, heads, D] -> float32 [B, heads, S + rows, cols], zero-padded."""
    return torch.nn.functional.pad(t.float(), (0, cols - t.shape[-1], 0, 0, 0, rows)
                                   ).permute(0, 2, 1, 3)


def _key_range(q0, q_last, Skv, causal, window, BK):
    orphans = window is not None and q_last >= Skv - 1 + window
    k_end = min(Skv, q_last + 1) if causal else Skv
    k_begin = max(0, q0 - window + 1) if window and not orphans else 0
    return k_begin // BK * BK, k_end, orphans


def _visible(rows, keys, Skv, causal, window, s):
    vis = torch.ones(len(rows), len(keys), dtype=torch.bool)
    if causal:
        vis &= keys[None, :] <= rows[:, None]
    if window:
        vis &= rows[:, None] - keys[None, :] < window
    s = torch.where(vis, s, -1e30)
    return torch.where(keys[None, :] >= Skv, -math.inf, s)


def sm90_scores(qt, kt, route, ng, gw, Dp):
    """A tile's raw scores on the tensor-core kernel's ``route``: qt [...,
    64, W] and kt [..., BK, W] zero-padded to W columns."""
    mm = lambda a, b: a @ b.transpose(-1, -2)        # noqa: E731
    if route == "sm90":
        return mm(qt, kt)
    if route == "sm90_wide":
        s = torch.zeros(*qt.shape[:-1], kt.shape[-2])
        for c0 in range(0, Dp, 64):
            s = s + mm(qt[..., c0:c0 + 64], kt[..., c0:c0 + 64])
        return s
    parts = []
    for g in range(ng):
        part = torch.zeros(*qt.shape[:-1], kt.shape[-2])
        for c in range(g * gw, (g + 1) * gw, 16):
            part = part + mm(qt[..., c:c + 16], kt[..., c:c + 16])
        parts.append(part)
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    return s


def sm90_model(q, k, v, *, causal, window, record=None):
    """What the tensor-core kernel computes for q's type (bf16 or fp16) at
    any D (the wrapper's padding to a multiple of 8 included); ``record``
    (a list) gets (group, q0, wg, m, l) after each warpgroup's last tile."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dp = -(-D // 8) * 8
    ng, gw = ops.column_groups(Dp, q.dtype)
    route = ops.sm90_route(Dp)
    if route == "sm90":
        DP = -(-Dp // 32) * 32
        BK = 128 if DP <= 64 else 64 if DP <= 160 else 32
        width = gw = DP
    else:
        BK = 32 if route == "sm90_cluster" or gw > 160 else 64
        width = ng * gw
    n_kt = -(-Skv // BK)
    qf = _padded(q, width)
    kf, vf = (_padded(t, width, n_kt * BK - Skv).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, H, Sq, width)
    for q0 in range(0, Sq, 128):
        k_begin, k_end, orphans = _key_range(q0, min(q0 + 128, Sq) - 1, Skv,
                                             causal, window, BK)
        for r_lo in (q0, q0 + 64):
            if r_lo >= Sq:
                continue
            rows = torch.arange(r_lo, r_lo + 64)
            m = [torch.full((B, H, 64), -1e30) for _ in range(ng)]
            l = [torch.zeros(B, H, 64) for _ in range(ng)]
            o = [torch.zeros(B, H, 64, gw) for _ in range(ng)]
            qt = qf[:, :, r_lo:r_lo + 64]
            qt = torch.nn.functional.pad(qt, (0, 0, 0, 64 - qt.shape[2]))
            for k0 in range(k_begin, k_end, BK):
                if not orphans and ((causal and k0 > r_lo + 63) or (
                        window and k0 + BK - 1 < r_lo - window + 1)):
                    continue
                s = sm90_scores(qt, kf[:, :, k0:k0 + BK], route, ng, gw, Dp)
                s = _visible(rows, torch.arange(k0, k0 + BK), Skv, causal, window,
                             s * scale)
                # every group (CTA) runs the same softmax on the same S
                for g in range(ng):
                    m_new = torch.maximum(m[g], s.amax(-1))
                    corr = torch.exp2((m[g] - m_new) * LOG2E)
                    p = torch.exp2((s - m_new[..., None]) * LOG2E)
                    l[g] = l[g] * corr + p.sum(-1)
                    o[g] = (o[g] * corr[..., None]
                            + p.to(q.dtype).float() @ vf[:, :, k0:k0 + BK, g * gw:(g + 1) * gw])
                    m[g] = m_new
            n = min(64, Sq - r_lo)
            for g in range(ng):
                if record is not None:
                    record.append((g, q0, r_lo, m[g], l[g]))
                out[:, :, r_lo:r_lo + n, g * gw:(g + 1) * gw] = (
                    o[g] / torch.clamp(l[g], min=1e-30)[..., None])[:, :, :n]
    assert not out[..., D:].any()                # the padded columns stay zero
    return out[..., :D].permute(0, 2, 1, 3).to(q.dtype)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) in float32: the product is exact in float64, and the
    sum is rounded once more to float32 (a double rounding that fmaf does
    not do; it moves a result by an ulp at most, and rarely)."""
    return (a.double() * b.double() + c.double()).float()


def simt_scores(qt: torch.Tensor, kt: torch.Tensor, D: int, chunk: int | None):
    """A tile's scores as the SIMT kernel sums them: qt [..., BQ, D'] (q
    already scaled), kt [..., BK, D'], a chain of fmaf over d = 0..D-1; with
    ``chunk``, taken through chunks of that many columns, the chain carried
    from one chunk into the next."""
    s = torch.zeros(*qt.shape[:-1], kt.shape[-2])
    starts = range(0, D, chunk) if chunk else (0,)
    for c0 in starts:
        for d in range(c0, min(D, c0 + chunk) if chunk else D):
            s = fma(qt[..., d, None], kt[..., None, :, d], s)
    return s


def simt_model(q, k, v, *, causal, window, record=None, chunked=True):
    """What the fp32 SIMT kernel computes above D = 256 (D a multiple of 4):
    the column groups of ``ops.column_groups``; each group's scores through
    chunks of 128 columns (``chunked``) or in one chain; ``record`` gets
    (group, q0, m, l) after each query tile's last key tile."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    ng, gw = ops.column_groups(D, torch.float32)
    BQ, BK = 32, 32
    n_kt = -(-Skv // BK)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    qf = (q.float() * scale).permute(0, 2, 1, 3)
    kf, vf = (_padded(t, ng * gw, n_kt * BK - Skv).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    out = torch.zeros(B, H, Sq, ng * gw)
    for g in range(ng):
        cols = slice(g * gw, (g + 1) * gw)
        for q0 in range(0, Sq, BQ):
            q_last = min(q0 + BQ, Sq) - 1
            k_end = min(Skv, q_last + 1) if causal else Skv
            k_begin = (max(0, q0 - window + 1)
                       if window and q_last < Skv - 1 + window else 0)
            rows = torch.arange(q0, q0 + BQ)
            qt = qf[:, :, q0:q0 + BQ]
            qt = torch.nn.functional.pad(qt, (0, 0, 0, BQ - qt.shape[2]))
            m = torch.full((B, H, BQ), -1e30)
            shares = torch.zeros(B, H, BQ, 8)
            acc = torch.zeros(B, H, BQ, gw)
            for k0 in range(k_begin // BK * BK, k_end, BK):
                s = simt_scores(qt, kf[:, :, k0:k0 + BK], D, 128 if chunked else None)
                s = _visible(rows, torch.arange(k0, k0 + BK), Skv, causal, window, s)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                own = torch.zeros(B, H, BQ, 8)
                for i in range(BK // 8):
                    own = own + p[..., 8 * i:8 * i + 8]
                shares = shares * corr[..., None] + own
                acc = acc * corr[..., None]
                vt = vf[:, :, k0:k0 + BK, cols]
                for j in range(BK):
                    acc = fma(p[..., j, None], vt[:, :, None, j], acc)
                m = m_new
            a = shares[..., 0::2] + shares[..., 1::2]           # xor 1
            b = a[..., 0::2] + a[..., 1::2]                      # xor 2
            l = b[..., 0] + b[..., 1]                            # xor 4
            if record is not None:
                record.append((g, q0, m, l))
            n = min(BQ, Sq - q0)
            out[:, :, q0:q0 + n, cols] = (
                acc / torch.clamp(l, min=1e-30)[..., None])[:, :, :n]
    assert not out[..., D:].any()
    return out[..., :D].permute(0, 2, 1, 3)


TF32_MASK = -8192            # 0xffffe000: a float32 pattern's top 19 bits


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x as the 3xTF32 kernel feeds it to the tensor cores: hi = x
    with its low 13 bits cleared, and lo = x - hi (exact in float32) as the
    tensor core reads it, through its top 19 bits."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded to float32 toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b for an 8-deep a [..., M, 8] and b [..., 8, N]: the 8
    products of TF32 values are exact and so is their sum with acc in
    float64; rounded toward zero to float32, as the tensor core does (to
    within an ulp: it aligns and truncates the terms before it adds them)."""
    return round_to_zero(acc.double() + a.double() @ b.double())


def _mma3(acc, a, b):
    """The kernel's three products of one 8-deep step: lo hi, hi lo, hi hi."""
    (ah, al), (bh, bl) = a, b
    return _mma(_mma(_mma(acc, al, bh), ah, bl), ah, bh)


def tf32_model(q, k, v, *, causal, window, record=None, box=32):
    """What the 3xTF32 kernel computes for fp32 q, k, v at a head dim of
    129 to 2,048 (the wrapper's padding to a multiple of 4 included):
    ``(out, lse)``; ``record`` (a list) gets (group, q0, m, l) after each
    query tile's last key tile. ``box``: the columns of a score's chain on
    one accumulator (None: one chain over the group's columns)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dp = -(-D // 4) * 4
    ng, gw = ops.column_groups(Dp, torch.float32)
    if ng == 1:
        gw = -(-Dp // 32) * 32
    BQ, BK = 128, 32
    n_kt = -(-Skv // BK)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    qf = _padded(q.float() * scale, ng * gw, -(-Sq // BQ) * BQ - Sq)
    kf, vf = (_padded(t, ng * gw, n_kt * BK - Skv).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    qs, ks, vs = (tf32_split(t) for t in (qf, kf, vf))
    # 8-column steps with a column < D, by group
    steps = [range(g * gw, min((g + 1) * gw, Dp), 8) for g in range(ng)]
    out = torch.zeros(B, H, Sq, ng * gw)
    lse = torch.zeros(B, H, Sq)
    for q0 in range(0, Sq, BQ):
        k_begin, k_end, _ = _key_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal,
                                       window, BK)
        rows = torch.arange(q0, q0 + BQ)
        qt = [t[:, :, q0:q0 + BQ] for t in qs]
        m = [torch.full((B, H, BQ), -1e30) for _ in range(ng)]
        shares = [torch.zeros(B, H, BQ, 4) for _ in range(ng)]
        acc = [torch.zeros(B, H, BQ, gw) for _ in range(ng)]
        for k0 in range(k_begin, k_end, BK):
            kt = [t[:, :, k0:k0 + BK] for t in ks]
            part = []
            for g in range(ng):
                s = torch.zeros(B, H, BQ, BK)
                cols = box or gw
                for c0 in steps[g][::cols // 8]:          # a chain's columns
                    chain = torch.zeros(B, H, BQ, BK)
                    for c in [c for c in steps[g] if c0 <= c < c0 + cols]:
                        chain = _mma3(chain, [t[..., c:c + 8] for t in qt],
                                      [t[..., c:c + 8].transpose(-1, -2) for t in kt])
                    s = s + chain
                part.append(s)
            for g in range(ng):
                # every group sums the partials in the order 0, 1, ...
                s = part[0]
                for p_g in part[1:]:
                    s = s + p_g
                s = _visible(rows, torch.arange(k0, k0 + BK), Skv, causal, window, s)
                m_new = torch.maximum(m[g], s.amax(-1))
                corr = torch.exp(m[g] - m_new)
                p = torch.exp(s - m_new[..., None])
                own = torch.zeros(B, H, BQ, 4)
                for j in range(BK // 8):
                    own = own + p[..., 8 * j:8 * j + 8:2]
                    own = own + p[..., 8 * j + 1:8 * j + 8:2]
                shares[g] = shares[g] * corr[..., None] + own
                acc[g] = acc[g] * corr[..., None]
                ps = tf32_split(p)
                cols = slice(g * gw, (g + 1) * gw)
                tile = torch.zeros(B, H, BQ, gw)
                for j in range(BK // 8):
                    keys = slice(k0 + 8 * j, k0 + 8 * j + 8)
                    tile = _mma3(tile, [t[..., 8 * j:8 * j + 8] for t in ps],
                                 [t[:, :, keys, cols] for t in vs])
                acc[g] = acc[g] + tile
                m[g] = m_new
        n = min(BQ, Sq - q0)
        for g in range(ng):
            sh = shares[g]
            l = (sh[..., 0] + sh[..., 1]) + (sh[..., 2] + sh[..., 3])
            if record is not None:
                record.append((g, q0, m[g], l))
            d = torch.clamp(l, min=1e-30)
            out[:, :, q0:q0 + n, g * gw:(g + 1) * gw] = (acc[g] / d[..., None])[:, :, :n]
            if g == 0:
                lse[:, :, q0:q0 + n] = (m[g] + torch.log(d))[:, :, :n]
    assert not out[..., Dp:].any()               # the padded columns stay zero
    return out[..., :D].permute(0, 2, 1, 3), lse.reshape(B, KV, H // KV, Sq)
