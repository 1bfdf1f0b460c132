"""Householder reflector generation and application (port of ``householder.py``).

Generation has LAPACK xLARFG semantics, including the underflow-rescue
rescaling.  A reflector is ``P = I - tau * w @ w^H`` with ``w[first] = 1``
and ``P^H @ x = [beta, 0, ..., 0]`` on the active window, ``beta`` real
(for real input P is symmetric, so ``P @ x`` works too; for complex input
apply the adjoint, i.e. pass ``conj(tau)`` to :func:`refl_left`).  Complex
``tau`` is ``(beta - re(alpha))/beta - i im(alpha)/beta``.

Every generator is branch-free tensor code (``torch.where`` selects), so it
runs on the device without reading a value back to the host.  On the CPU a
real reflector of at most three entries (the sweeps' plain versions) takes
the same arithmetic in Python floats, bit for bit, at a fraction of the
tensor operations' overhead.
"""
from __future__ import annotations

import math

import torch

from .rotations import sqrt_rn


def _safemin(dtype) -> float:
    fi = torch.finfo(dtype)
    return float(2.0 * fi.tiny / fi.eps)


def _scaled_norm(x):
    """Overflow/underflow-safe 2-norm of a real or complex vector via
    max-scaling."""
    a = torch.abs(x)
    m = torch.max(a) if a.numel() else torch.zeros((), dtype=x.dtype, device=x.device)
    msafe = torch.where(m == 0, torch.ones_like(m), m)
    r = a / msafe
    return m * sqrt_rn(torch.sum(r * r))


def _hyp2(x, z):
    """sqrt(x^2 + z^2) with max-scaling (the JAX ``hyp3`` with y == 0)."""
    m = torch.maximum(torch.abs(x), torch.abs(z))
    ms = torch.where(m == 0, torch.ones_like(m), m)
    xs = x / ms
    zs = z / ms
    return m * sqrt_rn(xs * xs + zs * zs)


def _neg_copysign(mag, sgn):
    """-copysign(|mag|, sgn) with sign(0) = +1."""
    am = torch.abs(mag)
    return torch.where(sgn >= 0, -am, am)


def _hyp3(x, y, z):
    """sqrt(x^2 + y^2 + z^2) with max-scaling (the JAX ``hyp3``)."""
    m = torch.maximum(torch.maximum(torch.abs(x), torch.abs(y)), torch.abs(z))
    ms = torch.where(m == 0, torch.ones_like(m), m)
    xs, ys, zs = x / ms, y / ms, z / ms
    return m * sqrt_rn(xs * xs + ys * ys + zs * zs)


def _reflector_from_floats(alpha, tail):
    """``_reflector_from`` on a real CPU tail of at most two entries, in
    Python floats: the same IEEE operations in the same order (a sum of two
    squares does not depend on its order; ``math.sqrt`` is correctly
    rounded, as ``sqrt_rn``), without a tensor operation each.  None when a
    value is not finite or |beta| needs the underflow rescue: the tensor
    code takes those."""
    a = float(alpha)
    t = tail.tolist()
    if not all(math.isfinite(x) for x in t) or not math.isfinite(a):
        return None
    at = [abs(x) for x in t]
    m = max(at, default=0.0)
    ms = m if m != 0 else 1.0
    xnorm = m * math.sqrt(sum((x / ms) * (x / ms) for x in at)) if t else 0.0
    if xnorm == 0:
        return alpha.clone(), torch.zeros((), dtype=tail.dtype), torch.zeros_like(tail)
    # from here m > 0, beta != 0 and a - beta != 0 (beta's sign is not a's)
    m = max(abs(a), xnorm)
    xs, zs = a / m, xnorm / m
    h = m * math.sqrt(xs * xs + zs * zs)
    beta = -h if a >= 0 else h
    if abs(beta) < _safemin(tail.dtype):
        return None
    vtail = tail / torch.tensor(a - beta, dtype=tail.dtype)
    return (torch.tensor(beta, dtype=tail.dtype),
            torch.tensor((beta - a) / beta, dtype=tail.dtype), vtail)


def _reflector_from(alpha, tail):
    """Shared xLARFG core: returns (beta, tau, scaled_tail)."""
    if tail.is_complex():
        return _reflector_from_complex(alpha, tail)
    if tail.device.type == "cpu" and tail.numel() <= 2:
        out = _reflector_from_floats(alpha, tail)
        if out is not None:
            return out
    dt = tail.dtype
    sfmin = _safemin(dt)
    rsfmin = 1.0 / sfmin
    one = torch.ones((), dtype=dt, device=tail.device)
    zero = torch.zeros((), dtype=dt, device=tail.device)

    xnorm = _scaled_norm(tail)
    ar = alpha
    trivial = xnorm == 0

    beta = _neg_copysign(_hyp2(ar, xnorm), ar)

    # single-round underflow rescue (one multiply by 1/sfmin brings any
    # nonzero |beta| above sfmin in binary64)
    need = torch.abs(beta) < sfmin
    scl = torch.where(need, one * rsfmin, one)
    tail = tail * scl
    ar = ar * scl
    xnorm2 = _scaled_norm(tail)
    beta2 = _neg_copysign(_hyp2(ar, xnorm2), ar)
    beta_in = torch.where(need, beta2, beta)

    bsafe = torch.where(beta_in == 0, one, beta_in)
    tau = (beta_in - ar) / bsafe
    denom = ar - beta_in
    dsafe = torch.where(denom == 0, one, denom)
    vtail = tail / dsafe
    beta_out = torch.where(need, beta_in * sfmin, beta_in)

    tau = torch.where(trivial, zero, tau)
    vtail = torch.where(trivial, torch.zeros_like(vtail), vtail)
    beta_out = torch.where(trivial, alpha, beta_out)
    return beta_out, tau, vtail


def _reflector_from_complex(alpha, tail):
    """Complex xLARFG (zlarfg): real beta, complex tau; the JAX package's
    arithmetic order (1/denom as conj(denom)/|denom|^2)."""
    rdt = tail.real.dtype
    sfmin = _safemin(rdt)
    rsfmin = 1.0 / sfmin
    one = torch.ones((), dtype=rdt, device=tail.device)

    xnorm = _scaled_norm(tail)
    ar, ai = alpha.real, alpha.imag
    trivial = (xnorm == 0) & (ai == 0)
    beta = _neg_copysign(_hyp3(ar, ai, xnorm), ar)
    need = torch.abs(beta) < sfmin
    scl = torch.where(need, one * rsfmin, one)
    tail = tail * scl
    ar = ar * scl
    ai = ai * scl
    xnorm2 = _scaled_norm(tail)
    beta2 = _neg_copysign(_hyp3(ar, ai, xnorm2), ar)
    beta_in = torch.where(need, beta2, beta)

    bsafe = torch.where(beta_in == 0, one, beta_in)
    tau = torch.complex((beta_in - ar) / bsafe, -(ai / bsafe))
    dr, di = ar - beta_in, ai
    dz = (dr == 0) & (di == 0)
    dr = torch.where(dz, one, dr)
    di = torch.where(dz, torch.zeros_like(di), di)
    d2 = dr * dr + di * di
    vtail = tail * torch.complex(dr / d2, -di / d2)
    beta_out = torch.where(need, beta_in * sfmin, beta_in)

    tau = torch.where(trivial, torch.zeros_like(tau), tau)
    vtail = torch.where(trivial, torch.zeros_like(vtail), vtail)
    beta_out = torch.where(trivial, alpha.real, beta_out)
    return beta_out, tau, vtail


def reflector_masked(x, lo: int, hi: int = None):
    """xLARFG on the window ``x[lo:hi]`` of a vector.

    Returns ``(w, tau, beta)``: full-length ``w`` with ``w[lo] = 1``, the
    essential part in ``(lo, hi)`` and zeros elsewhere; scalar ``tau`` and
    real ``beta`` (the value that replaces ``x[lo]``).
    """
    n = x.shape[0]
    if hi is None:
        hi = n
    beta, tau, vtail = _reflector_from(x[lo], x[lo + 1:hi])
    w = torch.zeros_like(x)
    w[lo] = 1.0
    w[lo + 1:hi] = vtail
    return w, tau, beta


def reflector_small(x):
    """xLARFG on a tiny vector (first element is the pivot).

    Inactive trailing slots must be zero.  Returns ``(w, tau, beta)`` with
    ``w[0] = 1``.
    """
    beta, tau, vtail = _reflector_from(x[0], x[1:])
    w = torch.cat([torch.ones((1,), dtype=x.dtype, device=x.device), vtail])
    return w, tau, beta


def _conj(w):
    return torch.conj_physical(w) if w.is_complex() else w


def refl_mat(w, tau):
    """Dense k x k matrix ``I - tau w w^H`` for a small reflector."""
    k = w.shape[0]
    return torch.eye(k, dtype=w.dtype, device=w.device) - tau * torch.outer(w, _conj(w))


def refl_left(A, w, tau):
    """A <- (I - tau w w^H) @ A in place (rank-1 update); returns A."""
    t = _conj(w) @ A
    return A.sub_(tau * torch.outer(w, t))


def refl_right(A, w, tau):
    """A <- A @ (I - tau w w^H) in place; returns A."""
    t = A @ w
    return A.sub_(tau * torch.outer(t, _conj(w)))
