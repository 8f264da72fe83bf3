"""The JAX package's CPU arithmetic for the transcendental functions on the
boosting path, bit for bit in float64.

The port holds its CPU float64 results to the JAX package's exactly (the
parity tests run that package on the CPU under ``jax_enable_x64``). XLA's
CPU backend does not call the C library for ``exp``: it inlines a
Cephes-style rational approximation and compiles it with fused
multiply-adds on an x86 host that has them, and it flushes subnormal
results to zero. ``torch.exp`` and ``torch.sigmoid`` round a few values
in a thousand to the neighbouring double, and on the Titanic matrix that
ulp in the boosting gradients moves tied split gains, then trees, then
the validation metric (about 3e-4 of AuPR). XLA's ``log`` is the C
library's, which ``torch.log`` misses on about two values in ten thousand.

Every float64 tensor goes through the emulation below, a few hundred
elementwise ops a call: the boosting loop's tensors are small there, and
it is the parity path. That holds on a card too (the float64 tree
witness, which must reproduce the CPU's trees); there :func:`xla_sum`
adds on the host, since the card's scans associate otherwise. Tensors of
any other dtype (the card's float32) take the plain torch ops and are
held to the CPU by a tolerance, not bit for bit.
"""
from __future__ import annotations

import math
import struct

import torch

__all__ = ["exp", "log", "sigmoid", "softmax", "xla_sum"]

#: XLA's CPU reductions add this many elements a window
_WINDOW = 32


def _f64(bits: str) -> float:
    return struct.unpack("<d", struct.pack("<Q", int(bits, 16)))[0]


# XLA's constants for the f64 exp, as its CPU code generator emits them
_EXP_LO = _f64("C086232BDD7ABCD2")     # below: 0
_EXP_HI = _f64("40862E42FEFA39EF")     # above: +inf
_LOG2E = _f64("3FF71547652B82FE")
_LN2_HI = _f64("3FE62E4000000000")
_LN2_LO = _f64("3EB7F7D1CF79ABCA")
_P = (_f64("3F2089CDD5E44BE8"), _f64("3F9F06D10CCA2C7E"))
_Q = (_f64("3EC92EB6BC365FA0"), _f64("3F64AE39B508B6C0"),
      _f64("3FCD17099887E074"))
_ONE_BITS = 0x3FF0000000000000
_SPLIT = 134217729.0                   # 2^27 + 1, Veltkamp's splitter
_TINY = 2.2250738585072014e-308        # smallest normal double


def _two_prod(a, b):
    """(p, e) with p = fl(a*b) and a*b = p + e exactly (Dekker)."""
    p = a * b
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """(s, e) with s = fl(a+b) and a+b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma(a, b, c):
    """fl(a*b + c) with one rounding, emulated in float64: the exact
    product, an exact sum with ``c``, the low parts added with rounding
    to odd, then one round to nearest (Boldo and Melquiond, 2008)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, ve = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    away = torch.where(ve > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((ve != 0) & even, torch.nextafter(v, away), v)
    return th + v


def _exp_parts(x):
    """(e, s, t) with exp(x) = ((e*s)*s)*s * t as XLA's CPU code forms it:
    ``e`` the rational approximation on the reduced argument, ``s`` and
    ``t`` powers of two."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(xc, torch.full_like(xc, _LOG2E),
                         torch.full_like(xc, 0.5)))
    g = _fma(-n, torch.full_like(n, _LN2_HI), xc)
    g = _fma(-n, torch.full_like(n, _LN2_LO), g)
    g2 = g * g
    p = _fma(_fma(g2, torch.full_like(g2, _P[0]), torch.full_like(g2, _P[1])),
             g2, torch.ones_like(g2)) * g
    q = _fma(_fma(_fma(g2, torch.full_like(g2, _Q[0]),
                       torch.full_like(g2, _Q[1])),
                  g2, torch.full_like(g2, _Q[2])),
             g2, torch.full_like(g2, 2.0))
    e = (p / (q - p)) * 2.0 + 1.0
    ni = torch.clamp(n.to(torch.int64), -2099, 2099)
    b = ni >> 2
    s = ((b << 52) + _ONE_BITS).view(torch.float64)
    t = (((ni - 3 * b) << 52) + _ONE_BITS).view(torch.float64)
    return e, s, t


def _emulated(x: torch.Tensor) -> bool:
    return x.dtype == torch.float64


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` as the JAX package computes
    ``jax.nn.sigmoid`` and its metric's ``1 / (1 + exp(-m))`` on the CPU:
    the last product of the exp fused with the ``+ 1``, a subnormal
    quotient flushed to zero. Other tensors: ``torch.sigmoid``."""
    if not _emulated(x):
        return torch.sigmoid(x)
    xn = -x
    e, s, t = _exp_parts(xn)
    den = _fma(e * s * s * s, t, torch.ones_like(t))
    den = torch.where(xn < _EXP_LO, 1.0, den)
    den = torch.where(xn > _EXP_HI, torch.inf, den)
    r = 1.0 / den
    return torch.where(r < _TINY, 0.0, r)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` as XLA's CPU code computes it for ``jnp.exp`` (the softmax
    of the boosting gradients and of the metric): the product ((e*s)*s)*s
    * t, a subnormal result flushed to zero. Other tensors:
    ``torch.exp``."""
    if not _emulated(x):
        return torch.exp(x)
    e, s, t = _exp_parts(x)
    r = e * s * s * s * t
    r = torch.where(x < _EXP_LO, 0.0, r)
    r = torch.where(x > _EXP_HI, torch.inf, r)
    r = torch.where(r < _TINY, 0.0, r)
    return torch.where(torch.isnan(x), x, r)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: exp of the max-shifted values over their sum,
    with :func:`exp` (XLA's CPU exp on float64 tensors)."""
    e = exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D tensor as XLA's CPU code adds a float64 ``jnp.sum``:
    up to 32 elements in order; more are padded with zeros to a multiple
    of 32 (half the padding before, the larger half after), added 32 at a
    time in order, and the window sums reduced the same way. Other
    tensors: ``torch.sum``. A float64 tensor off the CPU is added on the
    host (one scalar comes back)."""
    if not _emulated(x):
        return torch.sum(x)
    if x.device.type != "cpu":
        return xla_sum(x.cpu()).to(x.device)
    n = x.shape[0]
    if n <= _WINDOW:
        return torch.cumsum(x, 0)[-1] if n else x.new_zeros(())
    pad = -n % _WINDOW
    w = torch.cat([x.new_zeros(pad // 2), x, x.new_zeros(pad - pad // 2)])
    return xla_sum(torch.cumsum(w.view(-1, _WINDOW), 1)[:, -1])


def log(x: torch.Tensor) -> torch.Tensor:
    """The C library's ``log`` elementwise on a float64 tensor (the
    JAX package's CPU ``log``; a Python loop, for the few values of a
    boosting base margin), else ``torch.log``."""
    if not _emulated(x):
        return torch.log(x)
    flat = [math.log(v) if v > 0 else (-math.inf if v == 0 else math.nan)
            for v in x.reshape(-1).tolist()]
    return torch.tensor(flat, dtype=x.dtype, device=x.device).reshape(
        x.shape)
