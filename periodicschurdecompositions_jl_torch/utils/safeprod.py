"""Overflow-safe signed products in (mantissa, exponent) form (port of
``utils/safeprod.py``).

Represents ``prod_l x[l]^(+1 if S[l] else -1)`` as ``alpha / beta * 2^scale``
with ``|alpha|`` in [1, 2) or 0, ``beta`` in {0, 1} (``beta = 0`` encodes an
infinite eigenvalue from a zero diagonal in an inverted factor) and an
integer ``scale``.  The product is renormalized after every factor, so no
intermediate over- or underflows even for long cycles.

Host scalars: the complex periodic QZ core evaluates these once per
deflated eigenvalue, on the diagonal entries it has already read back.
``math.frexp``/``math.ldexp`` are exact, as the JAX package's bitcast-free
``frexp_exp``/``pow2_scale`` are.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple


def pow2_scale(x, k: int):
    """Exact ``x * 2**k`` (real or complex ``x``; complex scales re and im)."""
    if isinstance(x, complex):
        return complex(math.ldexp(x.real, k), math.ldexp(x.imag, k))
    return math.ldexp(float(x), k)


def frexp_exp(mag) -> int:
    """The exponent e of ``mag = m * 2^e`` with m in [0.5, 1); zero and
    non-finite inputs give 0 (the JAX package's ``frexp_exp``)."""
    mag = float(mag)
    if mag == 0 or not math.isfinite(mag):
        return 0
    return math.frexp(mag)[1]


def _renorm(alpha: complex, scale: int) -> Tuple[complex, int]:
    """Rescale so that |alpha| is in [1, 2); alpha == 0 resets the scale."""
    mag = abs(alpha)
    if mag == 0:
        return 0j, 0
    e = frexp_exp(mag)              # mag = m * 2^e, m in [0.5, 1)
    return pow2_scale(alpha, 1 - e), scale + e - 1


def safeprod_signed(x: Sequence, S: Sequence[bool]) -> Tuple[complex, float, int]:
    """Scaled product of ``x[l] ** (+1 if S[l] else -1)``.

    ``x``: p host scalars (real or complex); ``S``: p bools.
    Returns (alpha: complex, beta: float, scale: int).
    """
    if len(x) != len(S):
        raise ValueError("safeprod_signed: x and S differ in length")
    alpha, beta, scale = 1 + 0j, 1.0, 0
    for xl, sl in zip(x, S):
        xl = complex(xl)
        if sl:
            alpha = alpha * xl
        elif xl == 0:
            beta = 0.0
        else:
            alpha = alpha / xl
        alpha, scale = _renorm(alpha, scale)
    return alpha, beta, scale
