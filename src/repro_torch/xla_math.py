"""Float32 functions computed the way XLA lowers them, where the port has
to be bit-equal to the JAX package.

XLA evaluates ``exp2(x)`` as ``exp(x * ln2)`` in float32, which is not an
exact power of two: ``exp2(15)`` is 32767.984, not 32768. The quantizer's
``qmax = 2**(bits-1) - 1`` and the score fidelity ``1 - 2**(1-bits)`` are
built on it in the reference, so the port builds them the same way.

XLA:CPU does not call libm for float32 ``log``, ``log1p`` or ``erf_inv``:
it emits its own polynomials, which round differently from PyTorch's
(``torch.log`` and ``jnp.log`` differ in the last bit on ~14% of uniform
inputs). ``log_xla``, ``log1p_xla`` and ``erfinv_xla`` transcribe the
LLVM IR that XLA:CPU emits for ``jnp.log``, ``jnp.log1p`` and
``jax.scipy.special.erfinv`` (dumped with ``XLA_FLAGS=--xla_dump_to=DIR``,
the ``*.ir-with-opt.ll`` files), operation for operation in float32:

* ``log``: Cephes' ``logf`` — the input split into a mantissa in
  [sqrt(1/2), sqrt(2)) and an exponent, a degree-9 polynomial in the
  mantissa minus one, the exponent's ln 2 added in two parts;
* ``log1p``: a Cephes rational approximation below |x| = sqrt(2) - 1,
  else ``log(1 + x)``;
* ``erf_inv``: Giles' single-precision polynomials in ``w =
  -log1p(-x*x)`` (below w = 5, or in ``sqrt(w)`` above), times ``x``.

The IR's order of operations is kept, and so is one thing only the
machine code shows (the ``*.o`` files of the same dump): the code
generator contracts each product that feeds one sum into an FMA
instruction, rounded once. ``fma_f32`` computes those exactly; every
other product and sum rounds to float32 on its own, as separate PyTorch
operations do on any device. Each constant is written as the double bit
pattern that the IR prints, so it can be checked against a dump. ``tests/test_torch_random.py`` holds all three bit for bit against
XLA on millions of inputs.

``exp_xla`` is XLA:CPU's float32 ``exp`` the same way (Cephes' ``expf``:
the input clamped to +-88.376, ``n = floor(x log2 e + 0.5)``, the
reduced argument in two FMAs, a degree-5 polynomial and ``2^n`` built
from the exponent bits). Float32 ``sin`` and ``pow`` are different: the
machine code XLA:CPU emits for them calls the C library's ``sinf`` and
``powf`` (the symbols its JIT resolves from the process), so ``sin_xla``
and ``pow_xla`` call those same functions, one element at a time, on the
host, with denormals flushed to zero as XLA:CPU runs.
``tests/test_torch_mobility.py`` holds all three bit for bit against
jitted ``jnp.exp``, ``jnp.sin`` and ``10.0 ** x``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

LN2_F32 = float(np.float32(np.log(2.0)))


def exp2_xla(x: torch.Tensor) -> torch.Tensor:
    """``exp(x * float32(ln 2))``: XLA's float32 ``exp2``. On the CPU it
    equals the reference bit for bit at every integer in [-40, 31]."""
    return torch.exp(x * LN2_F32)


def _c(bits: int) -> float:
    """The float32 constant the IR prints as the double pattern ``bits``."""
    return float(np.float32(np.array(bits, np.uint64).view(np.float64)))


_MIN_NORMAL = _c(0x3810000000000000)           # 2^-126
_SQRT_HALF = _c(0x3FE6A09E60000000)
# Cephes logf: the polynomial in x = mantissa - 1, highest power first
_LOG_P = [_c(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000,
                          0x3FBDE4A340000000, 0xBFBFCBA9E0000000,
                          0x3FC23D37E0000000, 0xBFC555CA00000000,
                          0x3FC999D580000000, 0xBFCFFFFF80000000,
                          0x3FD5555540000000)]
_LN2_LO = _c(0xBF2BD01060000000)               # -2.12194440e-4
_LN2_HI = _c(0x3FE6300000000000)               # 0.693359375
# log1p below |x| < sqrt(2) - 1: x - x^2/2 + x^3 N(x)/D(x)
_LOG1P_SMALL = _c(0x3FDA8279A0000000)
_LOG1P_NUM = [_c(b) for b in (0x3F07BC0960000000, 0x3FDFE818A0000000,
                              0x401A509F40000000, 0x403DE97380000000,
                              0x404E798EC0000000, 0x404C8E75A0000000,
                              0x40340A2020000000)]
_LOG1P_DEN = [1.0] + [_c(b) for b in (0x402E2035A0000000, 0x4054C30B60000000,
                                      0x406BB865A0000000, 0x4073519460000000,
                                      0x406B0DB140000000, 0x404E0F3040000000)]
# erf_inv: (coefficients for w < 5, for w >= 5), highest power first
_ERFINV = [(_c(a), _c(b)) for a, b in (
    (0x3E5E2CB100000000, 0xBF2A3E1360000000),
    (0x3E970966C0000000, 0x3F1A76AD60000000),
    (0xBECD8E6AE0000000, 0x3F561B8E40000000),
    (0xBED26B5820000000, 0xBF6E17BCE0000000),
    (0x3F2CA65B60000000, 0x3F77824F60000000),
    (0xBF548A8100000000, 0xBF7F38BAE0000000),
    (0xBF711C9DE0000000, 0x3F8354AFC0000000),
    (0x3FCF91EC60000000, 0x3FF006DB60000000),
    (0x3FF805C5E0000000, 0x4006A9EFC0000000))]
SQRT2_F32 = _c(0x3FF6A09E60000000)


def fma_f32(a, b, c) -> torch.Tensor:
    """Float32 ``a * b + c`` rounded once, as the FMA instructions that
    XLA:CPU's code generator contracts each single-use product and its
    sum into. The product is exact in float64; the float64 sum is made
    round-to-odd (its rounding error, exact by TwoSum, sets the last bit),
    so the final rounding to float32 is the fused one."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _is_zero(v: torch.Tensor) -> torch.Tensor:
    """``v == 0`` as XLA:CPU compares it, with denormals as zero."""
    return torch.abs(v) < _MIN_NORMAL


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``: NaN below 0, -inf at 0 (denormals
    included), +inf at +inf."""
    x = x.to(torch.float32)
    invalid = ~(x > 0.0)                       # <= 0, or NaN
    zero = _is_zero(x)
    pinf = x == float("inf")
    v = torch.where(x > _MIN_NORMAL, x, _MIN_NORMAL)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRT_HALF
    t = m - 1.0
    e = e - torch.where(low, 1.0, 0.0)
    t = t + torch.where(low, m, 0.0)           # 2m - 1 below sqrt(1/2)
    z = t * t
    t3 = z * t
    p = _LOG_P
    y0 = fma_f32(fma_f32(t, p[0], p[1]), t, p[2])
    y1 = fma_f32(fma_f32(t, p[3], p[4]), t, p[5])
    y2 = fma_f32(fma_f32(t, p[6], p[7]), t, p[8])
    y = fma_f32(y0, t3, y1)
    y = fma_f32(y, t3, y2)
    y = fma_f32(y, t3, e * _LN2_LO)
    r = fma_f32(z, -0.5, t)
    r = r + y
    r = fma_f32(e, _LN2_HI, r)
    out = torch.where(invalid, torch.full_like(bits, -1), r.view(torch.int32))
    out = torch.where(zero, torch.full_like(bits, -8388608), out)   # -inf
    out = torch.where(pinf, torch.full_like(bits, 0x7F800000), out)  # +inf
    return out.view(torch.float32)


def _horner(x: torch.Tensor, coefs, start: torch.Tensor) -> torch.Tensor:
    """``(((start + c0) x + c1) x + ...)``, each step one FMA: the IR's
    chain, in which the first term is ``x * 0 + c0`` (kept, for its NaN
    and signed zero)."""
    acc = start + coefs[0]
    for c in coefs[1:]:
        acc = fma_f32(acc, x, c)
    return acc


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``: a rational approximation for |x| below
    sqrt(2) - 1, else ``log(1 + x)``; a denormal ``x`` reads as zero."""
    x = x.to(torch.float32)
    x = torch.where(_is_zero(x), x * 0.0, x)
    large = log_xla(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    ratio = _horner(x, _LOG1P_NUM, zero) / _horner(x, _LOG1P_DEN, zero)
    small = x + fma_f32(x2, -0.5, (x * x2) * ratio)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, large)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' approximation, as XLA expands it)
    on XLA:CPU's ``log1p`` and a correctly rounded ``sqrt``; a denormal
    ``x`` reads as zero."""
    x = x.to(torch.float32)
    x = torch.where(_is_zero(x), x * 0.0, x)
    w = log1p_xla(x * -x)                      # log(1 - x^2) <= 0
    central = w > -5.0
    # float32 sqrt correctly rounded (as vsqrtps is) through float64:
    # PyTorch's vectorized float32 sqrt on the CPU is not
    root = torch.sqrt(-w.double()).to(torch.float32)
    t = torch.where(central, -2.5 - w, root - 3.0)
    pick = lambda a, b: torch.where(central, a, b)  # noqa: E731
    p = fma_f32(pick(*_ERFINV[0]), t, pick(*_ERFINV[1]))
    for a, b in _ERFINV[2:]:
        p = fma_f32(t, p, pick(a, b))
    return x * torch.where(torch.abs(x) == 1.0, float("inf"), p)


# XLA rewrites a reduction over more elements than this into windows of
# this many (its tree-reduction rewrite on the CPU)
_REDUCE_WINDOW = 32


def sum_xla(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of a 1-D float32 vector as XLA:CPU adds it: up to 32
    elements one after another from 0; a longer vector padded with zeros
    on both sides (the lower side takes the smaller half) to whole windows
    of 32, each window summed so, and the window sums summed the same way,
    recursively. Each addition rounds to float32."""
    n = v.shape[0]
    if n <= _REDUCE_WINDOW:
        acc = torch.zeros((), dtype=torch.float32, device=v.device)
        for i in range(n):
            acc = acc + v[i]
        return acc
    padded = -(-n // _REDUCE_WINDOW) * _REDUCE_WINDOW
    lo = (padded - n) // 2
    w = torch.nn.functional.pad(v, (lo, padded - n - lo)).reshape(
        -1, _REDUCE_WINDOW)
    acc = torch.zeros(w.shape[0], dtype=torch.float32, device=v.device)
    for j in range(_REDUCE_WINDOW):
        acc = acc + w[:, j]
    return sum_xla(acc)


def sum_fused_xla(v: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D float32 vector that XLA:CPU fuses into the loop
    computing its terms (the GSS oracle's masked bandwidth sum): from 16
    to 32 elements LLVM vectorizes that loop 8 lanes wide, unrolled twice,
    so lane j of two accumulators adds elements j + 16 k and j + 8 + 16 k
    in turn, the two accumulators are added lane by lane, the 8 lanes
    halved to 4, 2 and 1, and the n mod 16 elements left added one after
    another. Below 16 elements the loop is not vectorized (``sum_xla``);
    above 32 XLA sums through a reduce window first (``sum_xla``)."""
    n = v.shape[0]
    if n < 16 or n > _REDUCE_WINDOW:
        return sum_xla(v)
    m = n // 16 * 16
    a0, a1 = v[0:8], v[8:16]
    for k in range(16, m, 16):
        a0 = a0 + v[k:k + 8]
        a1 = a1 + v[k + 8:k + 16]
    acc = a0 + a1
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    r = acc[0]
    for i in range(m, n):
        r = r + v[i]
    return r


# Cephes expf as XLA:CPU emits it: the clamp, log2(e), the two parts of
# ln 2 and the polynomial, highest power first
_EXP_LO = _c(0xC055F33340000000)               # -88.37626
_EXP_HI = _c(0x4056333340000000)               # 88.37626
_LOG2E = _c(0x3FF7154760000000)
_EXP_P = [_c(b) for b in (0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                          0x3F81112100000000, 0x3FA5553820000000,
                          0x3FC5555540000000)] + [0.5]


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``exp`` for finite inputs: the input clamped to
    [-88.376, 88.376], ``n = floor(fma(x, log2 e, 0.5))`` clamped to
    [-127, 127], ``r = x - n ln2`` in two FMAs (ln 2 split in a high and a
    low part), ``p`` the polynomial in ``r`` by FMAs, then
    ``(fma(p, r*r, r) + 1) * 2^n``, a denormal result flushed to zero
    (XLA:CPU runs with denormals flushed)."""
    x = x.to(torch.float32)
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(-n, _LN2_HI, x)
    r = fma_f32(-n, _LN2_LO, r)
    p = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < _MIN_NORMAL, 0.0, out)


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's float32 ``sinf`` and ``powf``, the functions
    XLA:CPU's compiled code calls for ``sin`` and ``pow``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.sinf.restype = ctypes.c_float
    lib.sinf.argtypes = [ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Denormals to a zero of their sign, as XLA:CPU's flush-to-zero and
    denormals-are-zero modes see them."""
    return torch.where(_is_zero(v), v * 0.0, v)


def _host_map(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of each float32 element of ``x``, computed on the host with
    denormal inputs and results flushed to zero; the result keeps ``x``'s
    shape and device."""
    flat = _flush(x.detach().to("cpu", torch.float32)).reshape(-1).tolist()
    out = np.fromiter((fn(v) for v in flat), np.float32, count=len(flat))
    return _flush(torch.from_numpy(out).reshape(x.shape)).to(x.device)


def sin_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``sin``: the C library's ``sinf``."""
    return _host_map(_libm().sinf, x)


def pow_xla(base: float, x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``pow(base, x)`` for a constant ``base``: the C
    library's ``powf``. XLA does not rewrite ``10.0 ** x`` into an
    ``exp``: it calls ``powf(10, x)``."""
    b = float(np.float32(base))
    powf = _libm().powf
    return _host_map(lambda v: powf(b, v), x)
