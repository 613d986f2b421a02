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
32); on the wide kernel (up to ``ops.SM90_WIDE_PAIR_MAX``) every group sums
S over all of D in chunks of 64 columns in order (BK 64 at GW = 160, 32
above). Past the clusters' reach the split route runs (``split_model``).

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

``split_model`` is the split route (``csrc/flash_split.cuh``), which runs
fp32 past D = 2,048 and bf16 and fp16 past 1,792: per 128-row query tile,
the scores over the key tiles of ``key_range`` (128 keys in 16 bits, 64 in
fp32) computed once: in 16 bits as ``sm90_scores``' wide branch (64-column
chunks added in order) times 1/sqrt(D), in fp32 on q times 1/sqrt(D) as
``_split_scores_f32`` sums them (hi rounded to nearest, ``tf32_split_rn``;
32-column boxes of mma each rounded toward zero, the boxes added with a
compensation that starts each box's chain); keys
past Skv -inf, masked scores -1e30; a row's m the maximum of its tile
maxima (init -1e30); then for each column group, in key tiles of 32, P =
exp2((s - m) log2 e) (16 bits) or exp(s - m) (fp32), l as four shares of
the pair sums of keys 8 j + 2 t and 8 j + 2 t + 1 added in key order and
then in the shuffles' tree, and O += P V (P rounded to the input's type in
16 bits; in fp32 3xTF32 on ``tf32_split_rn``'s parts, each key tile's 12
mma on a fresh accumulator added to O); o = O / max(l, 1e-30), group 0's
lse = m + log(max(l,
1e-30)). No online rescale: the tiles a row block skips add exact zeros.

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
    assert route != "sm90_split", "the split route: split_model"
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
    """float64 x rounded to float32 toward zero: its significand cut to 24
    bits, which float32 holds exactly in its normal range; below it (the
    cast rounds to a subnormal) stepped toward zero where it rounded away."""
    f = (x.view(torch.int64) & -(1 << 29)).view(torch.float64).float()
    a = x.abs()
    tiny = (a < 2.0 ** -126) & (a > 0)
    if tiny.any():
        away = tiny & (f.double().abs() > a)
        f = torch.where(away, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def tf32_split_rn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x as the split route feeds it to the tensor cores: hi = x
    rounded to the nearest TF32 pattern (the bits plus 0x1000, the low 13
    cleared: ties away from zero), lo = x - hi read through its top 19
    bits."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)
    return hi, _tf32(x - hi)


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


def _split_scores_f32(qs, ks, Dp, compensated=True, chunk=8):
    """fp32 scores as the split route sums them: qs, ks the (hi, lo) splits
    of q (scaled) [..., M, W] and k [..., N, W] (W a multiple of 32, zeros
    past Dp); each 32-column box's four 8-column steps of three mma (lo hi,
    hi lo, hi hi, each the exact products' sum with the accumulator rounded
    toward zero) chained on c, the running compensation of the boxes' sum
    s, then Fast2Sum (t = s + c, c = (s - t) + c, s = t); the score is
    s + c. Not ``compensated``: each box's chain on a fresh accumulator and
    the boxes added in float32 (the 3xTF32 kernels' scheme). (A step wholly
    past Dp, which the kernel skips, adds exact zeros.) The products are
    taken ``chunk`` boxes at a time."""
    nbox = -(-Dp // 32)

    def boxes(x):        # [..., R, W] -> [..., box, step, R, 8]
        return x[..., :nbox * 32].unflatten(-1, (nbox, 4, 8)).movedim(-4, -2).double()

    (qh, ql), (kh, kl) = [boxes(x) for x in qs], [boxes(x) for x in ks]
    kh, kl = kh.transpose(-1, -2), kl.transpose(-1, -2)
    s = torch.zeros(*qh.shape[:-4], qh.shape[-2], kh.shape[-1])
    c = torch.zeros_like(s)
    for b0 in range(0, nbox, chunk):
        bs = slice(b0, b0 + chunk)
        terms = (ql[..., bs, :, :, :] @ kh[..., bs, :, :, :],
                 qh[..., bs, :, :, :] @ kl[..., bs, :, :, :],
                 qh[..., bs, :, :, :] @ kh[..., bs, :, :, :])
        for b in range(terms[0].shape[-4]):
            if not compensated:
                c = torch.zeros_like(s)
            for i in range(4):
                for term in terms:
                    c = round_to_zero(c.double() + term[..., b, i, :, :])
            total = s + c
            c = (s - total) + c if compensated else torch.zeros_like(s)
            s = total
    return s + c


def split_model(q, k, v, *, causal, window, record=None):
    """What the split route computes for q's type at a head dim past 256
    (the wrapper's padding included): ``(out, lse)``, lse ``[B, KV, G,
    Sq]``; ``record`` (a list) gets (group, q0, m, l) of each query tile."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    f32 = q.dtype == torch.float32
    Dp = -(-D // ops.ROW_MULTIPLE[q.dtype]) * ops.ROW_MULTIPLE[q.dtype]
    ng, gw = ops.column_groups(Dp, q.dtype)
    BN, BK = (64 if f32 else 128), 32
    keys = ops.split_keys(Skv)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    qf = _padded(q, ng * gw)
    kf, vf = (_padded(t, ng * gw, keys - Skv).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    if f32:
        qs, ks = tf32_split_rn(qf * scale), tf32_split_rn(kf)
        # V by group: [group, B, H, keys, gw]
        vs = [x.unflatten(-1, (ng, gw)).movedim(-2, 0) for x in tf32_split_rn(vf)]
    out = torch.zeros(B, H, Sq, ng * gw)
    lse = torch.zeros(B, H, Sq)
    for q0 in range(0, Sq, 128):
        # the tile's rows < Sq (each row's arithmetic is its own)
        n = min(128, Sq - q0)
        rows = torch.arange(q0, q0 + n)
        q_last = q0 + n - 1
        # kernel 1: the scores of the tiles of key_range, masked
        k_begin, k_end, _ = _key_range(q0, q_last, Skv, causal, window, BN)
        k_stop = k_begin + -(-(k_end - k_begin) // BN) * BN
        cols = slice(k_begin, k_stop)
        if f32:
            s = _split_scores_f32([x[:, :, q0:q0 + n] for x in qs],
                                  [x[:, :, cols] for x in ks], Dp)
        else:
            s = sm90_scores(qf[:, :, q0:q0 + n], kf[:, :, cols], "sm90_wide", ng,
                            gw, Dp) * scale
        s = _visible(rows, torch.arange(k_begin, k_stop), Skv, causal, window, s)
        tile_max = s.reshape(*s.shape[:-1], -1, BN).amax(-1)
        # kernel 2, a CTA a group (each group's m, l and P its own, from the
        # same operations): the tiles of 32 keys from key_range's
        k2_begin, k2_end, _ = _key_range(q0, q_last, Skv, causal, window, BK)
        m = [torch.maximum(torch.full((B, H, n), -1e30), tile_max.amax(-1))
             for _ in range(ng)]
        shares = [torch.zeros(B, H, n, 4) for _ in range(ng)]
        acc = torch.zeros(ng, B, H, n, gw)
        for k0 in range(k2_begin, k2_end, BK):
            st = s[..., k0 - k_begin:k0 - k_begin + BK]
            p = []
            for g in range(ng):
                if f32:
                    p.append(torch.exp(st - m[g][..., None]))
                else:
                    p.append(torch.exp2((st - m[g][..., None]) * LOG2E))
                pairs = p[g][..., 0::2] + p[g][..., 1::2]      # keys 8 j + 2 t (+1)
                for j in range(BK // 8):
                    shares[g] = shares[g] + pairs[..., 4 * j:4 * j + 4]
            p = torch.stack(p)
            if f32:
                ps = tf32_split_rn(p)
                tile = torch.zeros_like(acc)
                for j in range(BK // 8):
                    kk = slice(k0 + 8 * j, k0 + 8 * j + 8)
                    tile = _mma3(tile, [x[..., 8 * j:8 * j + 8] for x in ps],
                                 [x[..., kk, :] for x in vs])
                acc = acc + tile
            else:
                vt = vf[:, :, k0:k0 + BK].unflatten(-1, (ng, gw)).movedim(-2, 0)
                acc = acc + p.to(q.dtype).float() @ vt
        for g in range(ng):
            sh = shares[g]
            l = (sh[..., 0] + sh[..., 1]) + (sh[..., 2] + sh[..., 3])
            if record is not None:
                record.append((g, q0, m[g], l))
            d = torch.clamp(l, min=1e-30)
            out[:, :, q0:q0 + n, g * gw:(g + 1) * gw] = acc[g] / d[..., None]
            if g == 0:
                lse[:, :, q0:q0 + n] = m[g] + torch.log(d)
    out = out[..., :D].permute(0, 2, 1, 3)
    return (out if f32 else out.to(q.dtype)), lse.reshape(B, KV, H // KV, Sq)
