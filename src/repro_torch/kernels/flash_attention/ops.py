"""Wrapper of the flash-attention kernels.

``flash_attention(q, k, v, causal=, window=)`` computes causal or
sliding-window GQA attention, q ``[B, Sq, H, D]`` and k, v
``[B, Skv, KV, D]`` (fp32, bf16 or fp16, all the same type) ->
``[B, Sq, H, D]`` in q's type; query head h reads KV head
``h // (H // KV)``. CUDA tensors launch, on the current stream, the kernel
of their type and head dim or raise. bf16 and fp16 take the tensor-core
kernel (``csrc/flash_sm90.cuh``: ``wgmma`` fed by TMA, P rounded to the
input's type before P V; one translation unit a type), by head dim
(``sm90_route``): up to 256 one CTA a query tile; up to 320 (two groups of
160, where it measured faster) the wide kernel, each group's CTA
computing all of QK^T; from 321 to ``SM90_CLUSTER_MAX`` (1,792) the column
groups of a query tile one thread-block cluster that computes QK^T once;
above it the split route. fp32 goes by ``f32_route``: up to 128 the SIMT
kernel (``csrc/flash_simt.cuh``), up to 2,048 the 3xTF32 tensor-core
kernel (``csrc/flash_tf32.cuh``: mma.sync .tf32, each fp32 operand split
into two TF32 parts, three products; past 256 its clusters), above 2,048
the split route. The split route (``csrc/flash_split.cuh``,
``flash_attention_split_cuda``) is two kernels a piece of the call
(``split_pieces``): the scores, computed once on the tensor cores, scaled
and masked into a workspace of at most ``SPLIT_WORKSPACE_BYTES`` with each
row's maximum a key tile, then P V by column group from them. None falls
back to another: a launch the card refuses raises. All take every head
dim from 1 to ``MAX_HEAD_DIM``, D at run time when its rows are whole
16-byte copies (D a multiple of 8 in bf16 and fp16, of 4 in fp32); for any
other D the wrapper zero-pads q, k and v to the next such width
(``pad_head_dim``), keeps the scale 1/sqrt(D), launches and slices o. Up
to 256 each kernel is compiled for the widths of ``COMPILED_WIDTHS`` (D
rounded up to 32); above 256 O is cut into ``column_groups(D, dtype)``
groups of one of ``WIDE_GROUP_WIDTHS[dtype]`` columns (at most 224 on the
16-bit tensor cores, 256 in fp32), one group a CTA. The clusters
(bf16/fp16 321 to 1,792, 3xTF32 to 2,048: at most 8 CTAs, the portable
size) compute each group's partial scores over its own columns once and
sum them through distributed shared memory in the order g = 0, 1, ...;
the wide kernel (``csrc/flash_attention_sm90_wide.cu``, D up to 320)
computes the scores over all of D in each group's CTA, in chunks.
``MAX_HEAD_DIM`` is the largest D whose column groups fit grid z (65,535
groups of 224); the kernels' offsets are 64-bit wherever D multiplies a
row index. ``check_grid`` holds a call to the kernels' grid limits: B * H
up to 2^31 - 1, the query tiles (``query_tile_rows``) up to 65,535, the
column groups up to 65,535, and on the split route each piece's two grids
within CUDA's limits; a call past them raises.

Without grad (serving) CPU tensors run ``ref.attention_ref`` and the
kernels write no log-sum-exp. When grad mode is on and q, k or v requires
grad, the call goes through ``FlashAttention``: its forward is the kernel
with its log-sum-exp output on CUDA tensors and ``ref.flash_fwd_ref`` on
CPU tensors, and it saves (q, k, v, out, lse); its backward is
``ref.flash_bwd_ref`` on every device, the JAX package's blockwise
recompute (plain JAX there), so the CPU tests run the card's backward.

``flash_attention.launches`` counts every call that launched (the split
route's two launches a piece count as one call); ``.launches_bf16``,
``.launches_f16`` and ``.launches_f32`` count each type's; the counters of
``SM90_ROUTE_COUNTERS`` count the 16-bit kernels' calls by route
(``.launches_sm90``, ``.launches_sm90_wide``, ``.launches_sm90_cluster``,
``.launches_sm90_split``, both types together) and those of
``F32_ROUTE_COUNTERS`` each fp32 route's (``.launches_f32_simt``,
``.launches_f32_tf32``, ``.launches_f32_tf32_cluster``,
``.launches_f32_tf32_split``); ``.split_pieces`` counts the split route's
pieces, ``.launches_lse`` the calls that wrote the log-sum-exp, and
``.backward_calls`` the backward's calls.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor, Replicate

from .. import _build, check_cuda, is_cpu
from ...sharding.act import contiguous_stride
from .ref import attention_ref, flash_bwd_ref, flash_fwd_ref

GRID_X_MAX = 2**31 - 1          # CUDA's grid limits
GRID_YZ_MAX = 65535
NARROW_MAX = 256                 # the widest head dim a CTA holds whole
SIMT_MAX = 128                   # fp32: the widest head dim of the SIMT kernel
TF32_MAX = 2048                  # fp32: the 3xTF32 kernel's largest cluster
                                 # (8 CTAs, the portable size) of groups of 256
SM90_CLUSTER_MAX = 1792          # bf16/fp16: the tensor-core kernel's largest
                                 # cluster, 8 groups of 224 (a group of 256
                                 # spills: csrc/flash_sm90.cuh)
SM90_WIDE_PAIR_MAX = 320         # bf16/fp16: two groups of 160 ran faster on
                                 # the wide kernel (scripts/kernel_ab.py on an
                                 # H100: 2.10 against 2.72 ms at D = 264)
# above it, the widest column group of O a CTA holds: on the tensor cores a
# group of 256 spilled beside its chunk loop (csrc/flash_sm90.cuh)
GROUP_MAX = {torch.float32: 256, torch.bfloat16: 224, torch.float16: 224}
MAX_HEAD_DIM = GRID_YZ_MAX * min(GROUP_MAX.values())
COMPILED_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)
WIDE_GROUP_WIDTHS = {dt: tuple(range(160, g + 1, 32)) for dt, g in GROUP_MAX.items()}
# the head-dim multiple of each kernel's 16-byte rows: the TMA's strides
# (bf16, fp16), the cp.async copies (fp32)
ROW_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}
# dtype -> (C entry, attributes entry, per-route launch counter)
_ROUTES = {torch.float32: ("flash_attention_fwd_f32", "flash_attention_attrs_f32",
                           "launches_f32"),
           torch.bfloat16: ("flash_attention_fwd_bf16", "flash_attention_attrs_bf16",
                            "launches_bf16"),
           torch.float16: ("flash_attention_fwd_f16", "flash_attention_attrs_f16",
                           "launches_f16")}
# fp32's kernels by route (``f32_route``) -> their launch counters
F32_ROUTE_COUNTERS = {"simt": "launches_f32_simt", "tf32": "launches_f32_tf32",
                      "tf32_cluster": "launches_f32_tf32_cluster",
                      "tf32_split": "launches_f32_tf32_split"}
# the bf16/fp16 tensor-core kernels by route (``sm90_route``) -> their
# launch counters (both types together)
SM90_ROUTE_COUNTERS = {"sm90": "launches_sm90", "sm90_cluster": "launches_sm90_cluster",
                       "sm90_wide": "launches_sm90_wide", "sm90_split": "launches_sm90_split"}
# the split route: the scores of a piece of the call, at most (a module
# constant, not an option); query rows a tile; the workspace's keys a row,
# Skv rounded up to a multiple of SPLIT_KEY_PAD; and a row's tile maxima,
# one a SPLIT_MAX_KEYS of those keys (the fp32 scores kernel's key tile;
# the 16-bit one's, 128, uses every other)
SPLIT_WORKSPACE_BYTES = 1 << 30
SPLIT_ROWS = 128
SPLIT_KEY_PAD = 128
SPLIT_MAX_KEYS = 64
# the split route's C entry takes the type as a code
_SPLIT_DTYPE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def pad_head_dim(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` ``[..., D]`` zero-padded to the next multiple of ``multiple``
    columns (``t`` itself when D is one): the zero columns add exact zeros
    to every score and give zero columns of the output."""
    pad = -t.shape[-1] % multiple
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def column_groups(D: int, dtype: torch.dtype) -> tuple[int, int]:
    """O's column groups for a (padded) head dim D on the kernel of
    ``dtype``: ``(1, D)`` up to 256, else ``ng = ceil(D / GROUP_MAX)``
    groups of ``gw`` = ceil(D / ng) rounded up to 32 columns, one of
    ``WIDE_GROUP_WIDTHS[dtype]`` (the last group's columns past D are
    computed on zeros and not stored)."""
    if D <= NARROW_MAX:
        return 1, D
    ng = -(-D // GROUP_MAX[dtype])
    return ng, -(-(-(-D // ng)) // 32) * 32


def f32_route(D: int) -> str:
    """The fp32 kernel of (padded) head dim D: ``"simt"`` up to 128 (the
    SIMT kernel, which ties or beats SDPA there), ``"tf32"`` up to 256 (the
    3xTF32 tensor-core kernel, one CTA a query tile), ``"tf32_cluster"`` up
    to ``TF32_MAX`` (its column groups one cluster), ``"tf32_split"`` above
    (the split route in 3xTF32: the scores once into a workspace, then P V
    by column group)."""
    if D <= SIMT_MAX:
        return "simt"
    if D <= NARROW_MAX:
        return "tf32"
    return "tf32_cluster" if D <= TF32_MAX else "tf32_split"


def sm90_route(D: int) -> str:
    """The bf16/fp16 tensor-core kernel of (padded) head dim D: ``"sm90"``
    up to 256 (one CTA a query tile holds all of D), ``"sm90_wide"`` up to
    ``SM90_WIDE_PAIR_MAX`` (two groups of 160, each group's CTA computing
    all of QK^T, where it ran faster than the cluster), ``"sm90_cluster"``
    up to ``SM90_CLUSTER_MAX`` (the column groups of a query tile one
    cluster that computes QK^T once), ``"sm90_split"`` above (the split
    route: the scores once into a workspace, then P V by column group)."""
    if D <= NARROW_MAX:
        return "sm90"
    if D <= SM90_WIDE_PAIR_MAX:
        return "sm90_wide"
    return "sm90_cluster" if D <= SM90_CLUSTER_MAX else "sm90_split"


def route_of(dtype: torch.dtype, D: int) -> str:
    """The route of a (padded) head dim D in ``dtype``."""
    return f32_route(D) if dtype == torch.float32 else sm90_route(D)


def route_counter(dtype: torch.dtype, D: int) -> str:
    """The launch counter of the route of a (padded) head dim D in ``dtype``."""
    counters = F32_ROUTE_COUNTERS if dtype == torch.float32 else SM90_ROUTE_COUNTERS
    return counters[route_of(dtype, D)]


def query_tile_rows(dtype: torch.dtype, D: int) -> int:
    """The query rows a CTA of the kernel of ``dtype`` owns at (padded)
    head dim D: 128 on the tensor cores (bf16, fp16 and fp32 past 128), 64
    on the SIMT kernel."""
    return 64 if dtype == torch.float32 and f32_route(D) == "simt" else 128


def split_keys(Skv: int) -> int:
    """The split route's workspace keys a row: Skv rounded up to a multiple
    of ``SPLIT_KEY_PAD``."""
    return -(-Skv // SPLIT_KEY_PAD) * SPLIT_KEY_PAD


def split_pieces(B: int, H: int, Sq: int, Skv: int) -> list[tuple[int, int, int, int]]:
    """The pieces ``(bh0, nbh, t0, nt)`` the split route cuts a call into:
    the query tiles ``t0 .. t0 + nt - 1`` (``SPLIT_ROWS`` rows each) of the
    (batch, head) rows ``bh0 .. bh0 + nbh - 1`` (bh = b H + h), each
    (batch, head, query row) in exactly one piece and a piece's scores
    (``nbh * nt * SPLIT_ROWS * split_keys(Skv)`` fp32) within
    ``SPLIT_WORKSPACE_BYTES``. A piece is whole query tiles of every (batch,
    head) where one query tile of every (batch, head) fits, else one query
    tile of a range of (batch, head). Raises where one query tile of one
    (batch, head) does not fit (Skv past 2,097,152 keys) or Skv < 1."""
    if Skv < 1:
        raise ValueError(f"the split route needs Skv >= 1, got {Skv}")
    bh, tiles = B * H, -(-Sq // SPLIT_ROWS)
    tile = SPLIT_ROWS * split_keys(Skv) * 4     # one query tile of one (b, h)
    if tile > SPLIT_WORKSPACE_BYTES:
        raise ValueError(f"Skv = {Skv} keys: one query tile's scores ({tile} bytes) "
                         f"exceed the split route's workspace of "
                         f"{SPLIT_WORKSPACE_BYTES} bytes")
    if bh * tile <= SPLIT_WORKSPACE_BYTES:
        nt = SPLIT_WORKSPACE_BYTES // (bh * tile)
        return [(0, bh, t0, min(nt, tiles - t0)) for t0 in range(0, tiles, nt)]
    nbh = SPLIT_WORKSPACE_BYTES // tile
    return [(b0, min(nbh, bh - b0), t0, 1) for t0 in range(tiles)
            for b0 in range(0, bh, nbh)]


def split_grids(piece: tuple[int, int, int, int], Skv: int, D: int,
                dtype: torch.dtype) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """A piece's two grids (x, y, z): the scores kernel's (key tiles of 128
    keys in bf16 and fp16, 64 in fp32; the piece's query tiles; its (batch,
    head) rows) and the P V kernel's (the column groups, the query tiles,
    the (batch, head) rows; a query tile's groups next to each other)."""
    _, nbh, _, nt = piece
    key_tile = 2 * SPLIT_MAX_KEYS if dtype != torch.float32 else SPLIT_MAX_KEYS
    return ((split_keys(Skv) // key_tile, nt, nbh),
            (column_groups(D, dtype)[0], nt, nbh))


def check_grid(B: int, H: int, Sq: int, D: int, dtype: torch.dtype,
               Skv: int = 1) -> None:
    """Raise unless the call fits the kernels' grid limits: B * H up to
    2^31 - 1 (grid x), the query tiles of ``query_tile_rows`` up to 65,535
    (grid y), the column groups up to 65,535 (grid z); on the split route
    each piece's two grids (``split_grids``, ``Skv`` keys) within CUDA's
    limits, x up to 2^31 - 1, y and z up to 65,535. D is the padded head
    dim the kernel is given."""
    tiles = -(-Sq // query_tile_rows(dtype, D))
    groups = column_groups(D, dtype)[0]
    if B * H > GRID_X_MAX:
        raise ValueError(f"B * H = {B * H} exceeds the grid's x limit {GRID_X_MAX}")
    if tiles > GRID_YZ_MAX:
        raise ValueError(f"{tiles} query tiles (Sq = {Sq}) exceed the grid's "
                         f"y limit {GRID_YZ_MAX}")
    if groups > GRID_YZ_MAX:
        raise ValueError(f"{groups} column groups (D = {D}) exceed the grid's "
                         f"z limit {GRID_YZ_MAX}")
    if route_of(dtype, D).endswith("split") and Sq > 0:
        for piece in split_pieces(B, H, Sq, Skv):
            for grid in split_grids(piece, Skv, D, dtype):
                if not (0 < grid[0] <= GRID_X_MAX and 0 < grid[1] <= GRID_YZ_MAX
                        and 0 < grid[2] <= GRID_YZ_MAX):
                    raise ValueError(f"the split route's piece {piece} needs the "
                                     f"grid {grid}, past CUDA's limits")


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> tuple:
    """Raise unless q, k, v are CUDA tensors the kernels take; returns
    (B, Sq, H, D, Skv, KV, the padded D)."""
    _check_window(window)
    dev = q.device
    if q.dtype not in _ROUTES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32, bfloat16 "
                        "or float16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, dtype=q.dtype, ndim=4, device=dev)
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B,Sq,H,D] / [B,Skv,KV,D]")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is outside the kernels' 1..{MAX_HEAD_DIM}")
    Dp = -(-D // ROW_MULTIPLE[q.dtype]) * ROW_MULTIPLE[q.dtype]
    check_grid(B, H, Sq, Dp, q.dtype, Skv)
    return B, Sq, H, D, Skv, KV, Dp


def _padded(q, k, v) -> tuple:
    """q, k, v zero-padded to whole 16-byte rows, each 16-byte aligned."""
    out = tuple(pad_head_dim(t, ROW_MULTIPLE[q.dtype]) for t in (q, k, v))
    for name, t in zip("qkv", out):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return out


def _count(dtype: torch.dtype, route: str, with_lse: bool) -> None:
    flash_attention.launches += 1
    for name in (_ROUTES[dtype][2], route):
        setattr(flash_attention, name, getattr(flash_attention, name) + 1)
    flash_attention.launches_lse += int(with_lse)


def flash_attention_split_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, window: int | None = None,
                               with_lse: bool = False):
    """The split route on CUDA tensors, at any head dim past 256 (the
    wrapper sends it fp32 past 2,048 and bf16 and fp16 past 1,792): for
    each piece of ``split_pieces``, on the current stream, the scores
    kernel into a workspace on q's device, then the P V kernel; ``out``, or
    ``(out, lse)`` as ``flash_attention_cuda``. Counts one call on
    ``launches``, the type's counter and the split route's, and its pieces
    on ``split_pieces``."""
    B, Sq, H, D, Skv, KV, Dp = _checked(q, k, v, window)
    if Dp <= NARROW_MAX:
        raise ValueError(f"the split route takes head dims past {NARROW_MAX}, got {D}")
    qk, kk, vk = _padded(q, k, v)
    dev = q.device
    o = torch.empty_like(qk)
    lse = (torch.empty((B, KV, H // KV, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if Sq > 0:
        pieces = split_pieces(B, H, Sq, Skv)
        keys = split_keys(Skv)
        rows = max(nbh * nt for _, nbh, _, nt in pieces) * SPLIT_ROWS
        ws = torch.empty(rows * keys, dtype=torch.float32, device=dev)
        maxes = torch.empty(rows * (keys // SPLIT_MAX_KEYS), dtype=torch.float32,
                            device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _build.library()
        for bh0, nbh, t0, nt in pieces:
            err = lib.flash_attention_split(
                _SPLIT_DTYPE[q.dtype], qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
                o.data_ptr(), None if lse is None else lse.data_ptr(), ws.data_ptr(),
                maxes.data_ptr(), B, Sq, Skv, H, KV, Dp, int(causal),
                0 if window is None else int(window), 1.0 / D ** 0.5, bh0, nbh, t0,
                nt, keys, stream)
            _build.check(err, "flash_attention_split")
        _count(q.dtype, F32_ROUTE_COUNTERS["tf32_split"] if q.dtype == torch.float32
               else SM90_ROUTE_COUNTERS["sm90_split"], with_lse)
        flash_attention.split_pieces += len(pieces)
    if o.shape[3] != D:
        o = o[..., :D].contiguous()
    return (o, lse) if with_lse else o


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         with_lse: bool = False):
    """One launch of the kernel of q's type and head dim on CUDA tensors
    (past the clusters, ``flash_attention_split_cuda``): ``out``, or
    ``(out, lse)`` with ``lse`` ``[B, KV, G, Sq]`` fp32 (the log-sum-exp
    of each row's scaled scores, natural log) when ``with_lse``."""
    B, Sq, H, D, Skv, KV, Dp = _checked(q, k, v, window)
    route = route_of(q.dtype, Dp)
    if route.endswith("split"):
        return flash_attention_split_cuda(q, k, v, causal=causal, window=window,
                                          with_lse=with_lse)
    qk, kk, vk = _padded(q, k, v)
    dev = q.device
    o = torch.empty_like(qk)
    lse = (torch.empty((B, KV, H // KV, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if Sq > 0:
        entry = _ROUTES[q.dtype][0]
        err = getattr(_build.library(), entry)(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, H, KV, Dp, int(causal),
            0 if window is None else int(window), 1.0 / D ** 0.5,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, entry)
        _count(q.dtype, route_counter(q.dtype, Dp), with_lse)
    if o.shape[3] != D:
        o = o[..., :D].contiguous()
    return (o, lse) if with_lse else o


class FlashAttention(torch.autograd.Function):
    """Flash attention with the JAX package's custom VJP: the forward saves
    (q, k, v, out, lse), the backward is ``flash_bwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if is_cpu(q):
            out, lse = flash_fwd_ref(q, k, v, causal=causal, window=window)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_ref(q, k, v, out, lse, dout, causal=ctx.causal,
                                   window=ctx.window)
        flash_attention.backward_calls += 1
        return dq, dk, dv, None, None


def _local_placements(mine, other) -> list:
    """Placements of an attention operand under which each rank attends
    on its own: the batch (dim 0) stays sharded, the heads (dim 2) where
    the other operand's heads are sharded alike, every other dim
    replicated."""
    out = []
    for p, o in zip(mine, other):
        keep = (p.is_shard(0) and o.is_shard(0)) or (p.is_shard(2) and o.is_shard(2))
        out.append(p if keep else Replicate())
    return out


def _flash_dtensor(q, k, v, causal, window):
    """DTensors reach the kernel (or, on ``meta`` shards, the plain
    version) through their local shards: q, k and v are redistributed to
    placements under which each rank's attention is local
    (``_local_placements``), the wrapper runs on ``to_local()``, and the
    result is q's placements' DTensor."""
    mesh = q.device_mesh
    q_pl = _local_placements(q.placements, k.placements)
    k_pl = _local_placements(k.placements, q.placements)
    q = q.redistribute(mesh, q_pl)
    k, v = k.redistribute(mesh, k_pl), v.redistribute(mesh, k_pl)
    out = flash_attention(q.to_local(), k.to_local(), v.to_local(),
                          causal=causal, window=window).contiguous()
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=q.shape, stride=contiguous_stride(q.shape))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    _check_window(window)
    if isinstance(q, DTensor):
        return _flash_dtensor(q, k, v, causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "meta":
        # the dry-run's shapes: the blockwise plain version, whose memory
        # is the kernel's (the JAX package's dry-run traces its blockwise
        # attention), not attention_ref's S x S scores
        return flash_fwd_ref(q, k, v, causal=causal, window=window)[0]
    if is_cpu(q):
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
flash_attention.launches_f32 = 0
for _name in (*F32_ROUTE_COUNTERS.values(), *SM90_ROUTE_COUNTERS.values()):
    setattr(flash_attention, _name, 0)
flash_attention.launches_bf16 = 0
flash_attention.launches_f16 = 0
flash_attention.launches_lse = 0
flash_attention.split_pieces = 0
flash_attention.backward_calls = 0


def kernel_attributes(dtype: torch.dtype, head_dim: int) -> dict:
    """Registers a thread (at launch), spill (local) bytes a thread, and
    static and dynamic shared bytes a CTA of the compiled instance that
    takes (dtype, head_dim): up to 256 the one of width head_dim rounded up
    to 32, above it the cluster or wide one of ``column_groups(head_dim,
    dtype)``'s width, on the split route its P V kernel (and the scores
    kernel's under ``"scores_kernel"``); its route (``f32_route``,
    ``sm90_route``), the cluster size (1: none) and how many such clusters
    the card holds at once (0: no cluster)."""
    route = route_of(dtype, head_dim)
    keys = ("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes")
    if route.endswith("split"):
        out = (ctypes.c_int * 8)()
        err = _build.library().flash_attention_split_attrs(_SPLIT_DTYPE[dtype],
                                                          head_dim, out)
        _build.check(err, "flash_attention_split_attrs")
        res = dict(zip(keys, out[4:8]), scores_kernel=dict(zip(keys, out[:4])))
        res.update(route=route, cluster=1, max_active_clusters=0)
        return res
    out = (ctypes.c_int * 6)()
    entry = _ROUTES[dtype][1]
    err = getattr(_build.library(), entry)(head_dim, out)
    _build.check(err, entry)
    res = dict(zip(keys, out[:4]))
    res.update(route=route, cluster=out[4], max_active_clusters=out[5])
    return res
