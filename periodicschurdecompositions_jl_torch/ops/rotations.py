"""Givens rotation generation and pair application (port of ``rotations.py``).

Generation follows LAPACK dlartg/zlartg semantics: ``c`` is real and

    [ c        s ] [ f ]   [ r ]
    [ -conj(s) c ] [ g ] = [ 0 ],

with exact identity data for ``g == 0`` so structural zeros survive.
``givens_real``/``givens_complex`` are branch-free tensor code, so they run
on the device without a host read; ``givens_host`` is the same arithmetic
on host scalars, for generation chains that read their inputs back, and
for two 0-dim CPU tensors (the plain versions' generations).
The JAX package refines every division and sqrt by one Newton step on the
TPU's emulated float64; correctly rounded float64 needs no refinement, and
on the CPU the JAX package skips it too.

Application acts on an adjacent index pair (or triple) of rows or columns
of one ``(m, n)`` matrix, in place, with a host-side window ``[lo, hi)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  torch's CPU sqrt is not (its
    vectorized float64 sqrt is one ulp off for about 0.7% of arguments);
    numpy's and CUDA's are."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _host_scalars(f, g):
    """(f, g) as Python scalars when both are finite 0-dim CPU tensors (the
    plain versions' generations), else None."""
    if not (isinstance(f, torch.Tensor) and isinstance(g, torch.Tensor)
            and f.device.type == "cpu" and g.device.type == "cpu"
            and f.dim() == 0 and g.dim() == 0):
        return None
    f, g = f.item(), g.item()
    if not all(math.isfinite(x) for x in (f.real, f.imag, g.real, g.imag)):
        return None
    return f, g


def givens_real(f, g):
    """Real Givens: (c, s, r) with ``[c s; -s c] @ [f, g] = [r, 0]``, c >= 0.

    g == 0 -> (1, 0, f) exactly; f == 0 -> (0, sign(g), |g|).  On two
    finite 0-dim CPU tensors it runs ``givens_host``, the same arithmetic,
    without a tensor operation each.
    """
    fg = _host_scalars(f, g)
    if fg is not None and f.dtype == g.dtype == torch.float64:
        return tuple(torch.tensor(x, dtype=torch.float64) for x in givens_host(*fg))
    one = torch.ones_like(f)
    zero = torch.zeros_like(f)
    af, ag = torch.abs(f), torch.abs(g)
    scale = torch.maximum(af, ag)
    sc = torch.where(scale == 0, one, scale)
    fs, gs = f / sc, g / sc
    d = sc * sqrt_rn(fs * fs + gs * gs)
    dsafe = torch.where(d == 0, one, d)
    r_gen = torch.where(f >= 0, d, -d)
    c_gen = af / dsafe
    s_gen = g / torch.where(r_gen == 0, one, r_gen)
    sgn_g = torch.where(g >= 0, one, -one)
    c = torch.where(g == 0, one, torch.where(f == 0, zero, c_gen))
    s = torch.where(g == 0, zero, torch.where(f == 0, sgn_g, s_gen))
    r = torch.where(g == 0, f, torch.where(f == 0, ag, r_gen))
    return c, s, r


def givens_complex(f, g):
    """Complex Givens: (c, s, r); c real >= 0, s and r complex.

    ``[c s; -conj(s) c] @ [f, g] = [r, 0]``.
    g == 0 -> (1, 0, f) exactly; f == 0 -> (0, conj(g)/|g|, |g|).
    The arithmetic is spelled out on real and imaginary parts, in the JAX
    package's order (complex products as re*re - im*im, re*im + im*re).
    On two finite 0-dim complex128 CPU tensors it runs ``givens_host``.
    """
    fg = _host_scalars(f, g)
    if fg is not None and f.dtype == g.dtype == torch.complex128:
        c, s, r = givens_host(complex(fg[0]), complex(fg[1]))
        return (torch.tensor(c, dtype=torch.float64), torch.tensor(s, dtype=torch.complex128),
                torch.tensor(r, dtype=torch.complex128))
    f = torch.as_tensor(f)
    g = torch.as_tensor(g, device=f.device)
    if not f.is_complex():
        f = f.to(torch.complex128)
    g = g.to(f.dtype)
    fr, fi, gr, gi = f.real, f.imag, g.real, g.imag
    one = torch.ones_like(fr)
    zero = torch.zeros_like(fr)
    scale = torch.maximum(torch.maximum(fr.abs(), fi.abs()),
                          torch.maximum(gr.abs(), gi.abs()))
    sc = torch.where(scale == 0, one, scale)
    fsr, fsi, gsr, gsi = fr / sc, fi / sc, gr / sc, gi / sc
    f2 = fsr * fsr + fsi * fsi
    g2 = gsr * gsr + gsi * gsi
    af = sqrt_rn(f2)
    d = sqrt_rn(f2 + g2)
    dsafe = torch.where(d == 0, one, d)
    afsafe = torch.where(af == 0, one, af)
    c_gen = af / dsafe
    fgr, fgi = fsr / afsafe, fsi / afsafe                 # fsign = f/|f|
    r_gen = torch.complex(fgr * d * sc, fgi * d * sc)
    s_gen = torch.complex((fgr * gsr + fgi * gsi) / dsafe,
                          (fgi * gsr - fgr * gsi) / dsafe)
    ag = sqrt_rn(g2)
    agsafe = torch.where(ag == 0, one, ag)
    s_f0 = torch.complex(gsr / agsafe, -(gsi / agsafe))
    r_f0 = torch.complex(ag * sc, zero)
    g_is0 = (gr == 0) & (gi == 0)
    f_is0 = (fr == 0) & (fi == 0)
    c = torch.where(g_is0, one, torch.where(f_is0, zero, c_gen))
    s = torch.where(g_is0, torch.zeros_like(f), torch.where(f_is0, s_f0, s_gen))
    r = torch.where(g_is0, f, torch.where(f_is0, r_f0, r_gen))
    return c, s, r


def givens_host(f, g):
    """``givens_real``/``givens_complex`` on host scalars (Python floats or
    complex), with the same operations in the same order; returns Python
    scalars (c, s, r)."""
    if isinstance(f, complex) or isinstance(g, complex):
        f, g = complex(f), complex(g)
        if g == 0:
            return 1.0, 0j, f
        fr, fi, gr, gi = f.real, f.imag, g.real, g.imag
        scale = max(max(abs(fr), abs(fi)), max(abs(gr), abs(gi)))
        sc = 1.0 if scale == 0 else scale
        fsr, fsi, gsr, gsi = fr / sc, fi / sc, gr / sc, gi / sc
        f2 = fsr * fsr + fsi * fsi
        g2 = gsr * gsr + gsi * gsi
        if f == 0:
            ag = math.sqrt(g2)
            ags = 1.0 if ag == 0 else ag
            return 0.0, complex(gsr / ags, -(gsi / ags)), complex(ag * sc, 0.0)
        af = math.sqrt(f2)
        d = math.sqrt(f2 + g2)
        ds = 1.0 if d == 0 else d
        afs = 1.0 if af == 0 else af
        fgr, fgi = fsr / afs, fsi / afs
        return (af / ds, complex((fgr * gsr + fgi * gsi) / ds, (fgi * gsr - fgr * gsi) / ds),
                complex(fgr * d * sc, fgi * d * sc))
    f, g = float(f), float(g)
    if g == 0:
        return 1.0, 0.0, f
    if f == 0:
        return 0.0, (1.0 if g >= 0 else -1.0), abs(g)
    af, ag = abs(f), abs(g)
    sc = max(af, ag)
    fs, gs = f / sc, g / sc
    d = sc * math.sqrt(fs * fs + gs * gs)
    r = d if f >= 0 else -d
    return af / d, g / r, r


def lmat_host(c, s):
    """lmat(c, s) as nested host lists."""
    return [[c, s], [-s.conjugate(), c]]


def rmat_adj_host(c, s):
    """rmat_adj(c, s) as nested host lists."""
    return [[c, -s], [s.conjugate(), c]]


def _m2(a, b, c, d):
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.promote_types(c.dtype, d.dtype))
    return torch.stack([torch.stack([a.to(dt), b.to(dt)]),
                        torch.stack([c.to(dt), d.to(dt)])])


def lmat(c, s):
    """Left action of G(i, i+1, c, s) on the row pair: [[c, s], [-conj(s), c]]
    (c real)."""
    return _m2(c, s, -torch.conj_physical(s), c)


def rmat_adj(c, s):
    """Right action of G(i, i+1, c, s)' on the column pair:
    [[c, -s], [conj(s), c]] (c real).

    new_cols = old_cols @ rmat_adj(c, s); equals lmat(c, s)^H.
    """
    return _m2(c, -s, torch.conj_physical(s), c)


def _clamp(x: int, lo: int, hi: int) -> int:
    return min(max(int(x), lo), hi)


def _span(lo, hi, size):
    a = 0 if lo is None else _clamp(lo, 0, size)
    b = size if hi is None else _clamp(hi, 0, size)
    return a, max(a, b)


def rowsk(H, i: int, M, lo: int = None, hi: int = None, rhi: int = None):
    """k-row slab update in place: H[i:i+k, lo:hi] = M @ H[i:i+k, lo:hi].

    As the JAX package's ``rowsk``: ``i`` is clamped to [0, m-k] and the
    column window [lo, hi) may reach outside the matrix.  ``rhi``: the
    want_t=False bound, as the JAX package's masked update: the columns >=
    rhi keep their values, the others take exactly those of the update
    without it (the product runs on the whole slab)."""
    k = M.shape[0]
    m, n = H.shape
    i = _clamp(i, 0, m - k)
    a, b = _span(lo, hi, n)
    c = b if rhi is None else _clamp(rhi, a, b)
    if c > a:
        sl = H[i:i + k, a:b]
        if c == b:
            sl.copy_(M @ sl)
        else:
            sl[:, :c - a].copy_((M @ sl)[:, :c - a])
    return H


def colsk(H, j: int, M, lo: int = None, hi: int = None, clo: int = None):
    """k-column slab update in place: H[lo:hi, j:j+k] = H[lo:hi, j:j+k] @ M,
    with the clamping of ``rowsk``; ``clo``: the want_t=False bound (the
    rows < clo keep their values, the others take those of the update
    without it)."""
    k = M.shape[0]
    m, n = H.shape
    j = _clamp(j, 0, n - k)
    a, b = _span(lo, hi, m)
    c = a if clo is None else _clamp(clo, a, b)
    if b > c:
        sl = H[a:b, j:j + k]
        if c == a:
            sl.copy_(sl @ M)
        else:
            sl[c - a:].copy_((sl @ M)[c - a:])
    return H


def setel(H, i: int, j: int, val):
    """H[i, j] = val with i, j clamped into range (the JAX ``setel``)."""
    m, n = H.shape
    H[_clamp(i, 0, m - 1), _clamp(j, 0, n - 1)] = val
    return H


def givens_at(H, i0: int, j0: int, i1: int, j1: int):
    """``givens_host`` of H[i0, j0] and H[i1, j1] (indices clamped as the
    JAX ``getel``), read in one transfer."""
    m, n = H.shape
    f, g = H[[_clamp(i0, 0, m - 1), _clamp(i1, 0, m - 1)],
             [_clamp(j0, 0, n - 1), _clamp(j1, 0, n - 1)]].tolist()
    return givens_host(f, g)
