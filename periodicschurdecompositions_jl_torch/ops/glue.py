"""Per-iteration glue of the real periodic QR core (kernel G).

``glue_products_scan_shift`` computes, once per iteration of
``ops/pqr_real.py::pqr_real_core`` and from the ghost-padded ``(p, N, N)``
stack on its device: the band entries of the cycle product, the deflation
scan's bottom-most hit ``lnew`` and the normalized double-shift first column
v0 at ``m = lnew`` (``pqr_real._shift_v0``'s arithmetic), together with the
factor entries that the repair test and the 2x2 deflation read.  All of it
comes back in one packed float64 buffer, one device-to-host copy per
iteration.  The semantics are the glue of the JAX package's float64 core
(``ops/pqr_real.py``: unscaled band products, the smlnum terms), in numpy's
order of operations; the tests hold both versions to a numpy transcription
of that glue bit for bit.

* On a CUDA tensor it launches the hand-written kernel of ``csrc/glue.cu``
  (it replaces the Pallas kernel G of the JAX package's
  ``ops/pallas_glue.py``).  The JAX kernel runs in float-float with a
  per-factor binary renormalization and scans f32 hi parts, and the JAX
  package leaves it off by default after a TPU measurement; the port
  computes in float64 with correctly rounded operations (no FMA), and the
  kernel is its route on the card, with no switch.
* On a CPU tensor it runs ``glue_plain``, an eager torch version of the
  same arithmetic.  Any other device raises.

``launches["glue"]`` counts the kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .rotations import sqrt_rn
from .sweep import _check

launches = {"glue": 0}

_HEAD = 4  # lnew, v0


def out_len(p: int, n: int) -> int:
    """Length of the packed buffer: head, band (3n), factor entries (3p),
    the four entries of the repair test and S0[i]."""
    return _HEAD + 3 * n + 3 * p + 4


class Glue(NamedTuple):
    """One iteration's glue, unpacked on the host.

    ``D``, ``U`` (p, n) and ``S0`` (n,) hold only the entries the repair
    test and the 2x2 deflation at rows i-1, i read (``D[:, i-1]``,
    ``D[:, i]``, ``U[:, i-1]``, ``D[0, lnew-1]``, ``D[0, lnew]``,
    ``S0[i]``, ``S0[lnew]``), zeros elsewhere.
    """
    lnew: int
    v0: list
    hdiag: np.ndarray
    hsub: np.ndarray
    hsup: np.ndarray
    D: np.ndarray
    U: np.ndarray
    S0: np.ndarray


def unpack(g: np.ndarray, p: int, n: int, i: int, entries=None) -> Glue:
    """The ``Glue`` of the packed buffer ``g``.  The band and ``S0`` (which
    ``pqr_real_core`` writes) are arrays of their own.  ``D`` and ``U`` are
    new (p, n) arrays, or, given ``entries`` (a ``_FactorEntries``), its
    read-only arrays with this call's entries in place of the last call's."""
    lnew = int(g[0])
    band = g[_HEAD:_HEAD + 3 * n].reshape(3, n).copy()
    fac = g[_HEAD + 3 * n:_HEAD + 3 * n + 3 * p].reshape(p, 3)
    tail = g[_HEAD + 3 * n + 3 * p:]
    if entries is None:
        D, U = np.zeros((p, n)), np.zeros((p, n))
    else:
        D, U = entries.clear()
    if i >= 1:
        D[:, i - 1] = fac[:, 0]
        U[:, i - 1] = fac[:, 2]
    D[:, i] = fac[:, 1]
    S0 = np.zeros(n)
    S0[i] = tail[0]
    if lnew >= 1:
        D[0, lnew - 1] = tail[1]
    D[0, lnew] = tail[2]
    S0[lnew] = tail[3]
    if entries is not None:
        D, U = entries.hand_out(i, lnew)
    return Glue(lnew, g[1:_HEAD].tolist(), band[0], band[1], band[2], D, U, S0)


class _FactorEntries:
    """The (p, n) arrays ``D`` and ``U`` of ``Glue``, kept from call to call
    so that an iteration allocates none: ``clear`` zeroes the entries the
    last call wrote and returns the arrays for writing, ``hand_out``
    records this call's columns and returns read-only views of them."""

    def __init__(self, p: int, n: int):
        self.D = np.zeros((p, n))
        self.U = np.zeros((p, n))
        self.cols = ()
        self.views = []
        for a in (self.D, self.U):
            v = a.view()
            v.flags.writeable = False
            self.views.append(v)

    def clear(self):
        for c in self.cols:
            self.D[:, c] = 0.0
            self.U[:, c] = 0.0
        return self.D, self.U

    def hand_out(self, i: int, lnew: int):
        self.cols = tuple({c for c in (i - 1, i, lnew - 1, lnew) if c >= 0})
        return self.views


class _Buffers:
    """What the glue calls of one ``pqr_real_core`` run reuse (made by
    ``glue_buffers`` for one (card, p, n)): the device buffer the kernel
    writes (``out_len`` doubles, then its 3n of scratch), a pinned host
    buffer the result is copied into, and the factor entries' arrays."""

    def __init__(self, device, p: int, n: int):
        k = out_len(p, n)
        self.key = (device, p, n)
        self.dev = torch.empty(k + 3 * n, dtype=torch.float64, device=device)
        self.dev_out = self.dev[:k]
        self.host = torch.empty(k, dtype=torch.float64, pin_memory=True)
        self.host_np = self.host.numpy()
        self.entries = _FactorEntries(p, n)

    def read(self, stream) -> np.ndarray:
        """Copy the packed buffer into the pinned one on ``stream`` (the
        current stream of the buffer's card, the kernel's) and wait for it."""
        self.host.copy_(self.dev_out, non_blocking=True)
        stream.synchronize()
        return self.host_np


def glue_buffers(Hp: torch.Tensor, n: int):
    """The buffers that the glue calls on the padded stack ``Hp`` reuse
    from iteration to iteration (``glue_products_scan_shift``'s ``bufs``):
    one set for each run of the core, so that no two runs share them; None
    on the CPU."""
    if Hp.device.type != "cuda":
        return None
    return _Buffers(Hp.device, Hp.shape[0], n)


_EPS = float(np.finfo(np.float64).eps)
_TINY = float(np.finfo(np.float64).tiny)


def scan_constants(n: int, cfg):
    """(ulp, ulpx, smlnum) of the deflation scan, as ``pqr_real_core``'s."""
    return _EPS, cfg.ulp_x(_EPS), _TINY * (n / _EPS)


def glue_plain(Hp: torch.Tensor, n: int, l: int, i: int, its: int, cfg
               ) -> torch.Tensor:
    """Eager torch kernel G: the packed buffer (``out_len(p, n)`` doubles on
    Hp's device), with numpy's operations in numpy's order."""
    p, N, _ = Hp.shape
    dt, dev = Hp.dtype, Hp.device
    ulp, ulpx, smlnum = scan_constants(n, cfg)
    flat = Hp.reshape(p, N * N)
    r = torch.arange(n, device=dev)
    ghost = n * N + n  # a padded entry that stays exactly zero
    D = flat[:, r * N + r]
    U = flat[:, torch.where(r < n - 1, r * N + r + 1, ghost)]
    V = flat[:, torch.where(r < n - 2, r * N + r + 2, ghost)]
    S0 = flat[0, torch.where(r >= 1, r * N + r - 1, ghost)]
    z1 = torch.zeros(1, dtype=dt, device=dev)
    z2 = torch.zeros(min(n, 2), dtype=dt, device=dev)  # D[r+2] past the last row
    one = torch.ones(1, dtype=dt, device=dev)

    # band products of H[1] @ ... @ H[p-1], then H[0] times them
    P1 = torch.ones(n, dtype=dt, device=dev)
    P2 = torch.zeros(n, dtype=dt, device=dev)
    P3 = torch.zeros(n, dtype=dt, device=dev)
    for f in range(1, p):
        D1 = torch.cat([D[f, 1:], z1])
        U1 = torch.cat([U[f, 1:], z1])
        D2 = torch.cat([D[f, 2:], z2])
        P3 = P1 * V[f] + P2 * U1 + P3 * D2
        P2 = P1 * U[f] + P2 * D1
        P1 = P1 * D[f]
    d0, u0, s0 = D[0], U[0], S0
    hsub = s0 * torch.cat([one, P1[:-1]])
    hdiag = s0 * torch.cat([z1, P2[:-1]]) + d0 * P1
    hsup = s0 * torch.cat([z1, P3[:-1]]) + d0 * P2 + u0 * torch.cat([P1[1:], z1])

    # deflation scan: the bottom-most hit in rows [l+1, i]
    hh11 = torch.cat([z1, hdiag[:-1]])
    hh12 = torch.cat([z1, hsup[:-1]])
    a21 = torch.abs(hsub)
    tst1 = torch.abs(hh11) + torch.abs(hdiag)
    relax = a21 <= torch.clamp(ulp * tst1, min=smlnum)
    if cfg.slicot_convg:
        found = relax
    else:
        a12 = torch.abs(hh12)
        ab = torch.maximum(a21, a12)
        ba = torch.minimum(a21, a12)
        dd = torch.abs(hh11 - hdiag)
        aa = torch.maximum(torch.abs(hdiag), dd)
        bb = torch.minimum(torch.abs(hdiag), dd)
        stmp = aa + ab
        stmps = torch.where(stmp == 0, 1.0, stmp)
        at_ok = ba * (ab / stmps) <= torch.clamp(ulpx * (bb * (aa / stmps)), min=smlnum)
        found = (a21 <= smlnum) | ((a21 <= ulp * tst1) & at_ok)
        if its >= 16:
            found = found | relax
    found = found & (r >= l + 1) & (r <= i)
    if i > l:
        last = torch.where(found, r, -1).max()
        lnew = torch.where(last >= 0, last, l)
    else:
        lnew = torch.tensor(i, device=dev)

    # double-shift first column at m = lnew (pqr_real._shift_v0)
    def at(v, j):
        return v[torch.clamp(j, 0, n - 1)]

    exc1 = its == 10
    exc = exc1 or its % 10 == 0
    if exc1:
        sE = torch.abs(at(hsub, lnew + 1)) + torch.abs(at(hsub, lnew + 2))
        h44E = 0.75 * sE + hdiag[lnew]
    else:
        sE = torch.abs(hsub[i]) + torch.abs(hsub[max(i - 1, 0)])
        h44E = 0.75 * sE + hdiag[i]
    h33E = h44E
    h43h34E = -0.4375 * sE * sE
    im1 = max(i - 1, 0)
    h44, h33, h43, h34 = hdiag[i], hdiag[im1], hsub[i], hsup[im1]
    ssh = torch.abs(h33) + torch.abs(h34) + torch.abs(h43) + torch.abs(h44)
    sshs = torch.where(ssh == 0, 1.0, ssh)
    h33n, h44n, h34n, h43n = h33 / sshs, h44 / sshs, h34 / sshs, h43 / sshs
    trc = (h33n + h44n) * 0.5
    disc = (h33n - trc) * (h44n - trc) - h34n * h43n
    rtdisc = sqrt_rn(torch.abs(disc))
    r1, r2 = trc + rtdisc, trc - rtdisc
    pick = torch.where(torch.abs(r1 - h44n) <= torch.abs(r2 - h44n), r1, r2)
    zero = torch.zeros((), dtype=dt, device=dev)
    rt1r = torch.where(ssh == 0, zero, torch.where(disc >= 0, trc * ssh, pick * ssh))
    rt1i = torch.where((ssh != 0) & (disc >= 0), rtdisc * ssh, zero)
    rt2r, rt2i = rt1r, -rt1i

    m = lnew
    h11, h12 = hdiag[m], hsup[m]
    h21, h22, h32 = at(hsub, m + 1), at(hdiag, m + 1), at(hsub, m + 2)
    if exc or cfg.slicot_shifts:
        h44s = h44E - h11
        h33s = h33E - h11
        h21s_ = torch.where(h21 == 0, 1.0, h21)
        v = [(h33s * h44s - h43h34E) / h21s_ + h12, h22 - h11 - h33s - h44s, h32]
    else:
        sv = torch.abs(h11 - rt2r) + torch.abs(rt2i) + torch.abs(h21)
        svs = torch.where(sv == 0, 1.0, sv)
        h21s = h21 / svs
        v = [h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs) - rt1i * (rt2i / svs),
             h21s * (h11 + h22 - rt1r - rt2r), h21s * h32]
    s = torch.abs(v[0]) + torch.abs(v[1]) + torch.abs(v[2])
    s = torch.where(s == 0, 1.0, s)
    v0 = torch.stack([v[0] / s, v[1] / s, v[2] / s])

    # factor entries of the repair test and the 2x2 deflation
    if i >= 1:
        fac = torch.stack([D[:, i - 1], D[:, i], U[:, i - 1]], dim=1)
    else:
        fac = torch.stack([torch.zeros_like(D[:, 0]), D[:, 0], torch.zeros_like(D[:, 0])],
                          dim=1)
    tail = torch.stack([S0[i], torch.where(lnew >= 1, D[0, torch.clamp(lnew - 1, min=0)], zero),
                        D[0, lnew], S0[lnew]])
    return torch.cat([lnew.to(dt).reshape(1), v0, hdiag, hsub, hsup, fac.reshape(-1), tail])


def glue_products_scan_shift(Hp: torch.Tensor, n: int, l: int, i: int, its: int,
                             cfg, bufs=None) -> Glue:
    """Kernel G for one iteration of ``pqr_real_core`` (window [l, i],
    iteration ``its`` of the window): the packed buffer of ``glue_plain`` /
    ``csrc/glue.cu``, read back to the host in one copy and unpacked.

    On the card it writes into ``bufs`` (``glue_buffers(Hp, n)``, which a
    CUDA stack needs): the device buffer, the pinned host buffer and the
    (p, n) arrays ``D`` and ``U``, reused from call to call.  Each run of
    ``pqr_real_core`` makes its own, so two runs at once share none.  What
    the returned ``Glue`` holds is safe from the next call as far as the
    core needs: the band and ``S0`` (which the core writes) are copies of
    their own, and the pinned buffer is read before this call returns;
    ``D`` and ``U`` are read-only views that keep their values until the
    next call with the same ``bufs``, which the core makes only after it
    has read them (the repair test and ``_defl2`` read them within the
    iteration)."""
    p, N, _ = Hp.shape
    if Hp.device.type == "cpu":
        return unpack(glue_plain(Hp, n, l, i, its, cfg).numpy(), p, n, i)
    if Hp.device.type != "cuda":
        raise ValueError(f"glue_products_scan_shift: unsupported device {Hp.device}")
    _check_window(Hp, n, l, i)
    if bufs is None or bufs.key != (Hp.device, p, n):
        raise ValueError("glue_products_scan_shift: a CUDA stack needs glue_buffers(Hp, n)")
    stream = torch.cuda.current_stream(Hp.device)
    _launch(Hp, p, n, l, i, its, cfg, bufs.dev.data_ptr(), stream.cuda_stream)
    return unpack(bufs.read(stream), p, n, i, bufs.entries)


def _check_window(Hp, n, l, i):
    p, N, _ = Hp.shape
    _check("Hp", Hp, (p, N, N))
    if N != n + 1 or not (0 <= l <= i < n):
        raise ValueError(f"glue: bad window l={l} i={i} for n={n}, N={N}")


def _launch(Hp, p, n, l, i, its, cfg, out_ptr, stream_ptr):
    """Kernel G into the device buffer at ``out_ptr`` (``out_len(p, n)``
    doubles, then its 3n of scratch)."""
    ulp, ulpx, smlnum = scan_constants(n, cfg)
    with _cuda.on_device(Hp):
        _cuda.check(_cuda.load().psd_glue(
            Hp.data_ptr(), out_ptr, out_ptr + 8 * out_len(p, n), p, n, l, i, its,
            int(cfg.slicot_convg), int(cfg.slicot_shifts), ulp, ulpx, smlnum, stream_ptr),
            "glue")
    launches["glue"] += 1


def glue_cuda(Hp: torch.Tensor, n: int, l: int, i: int, its: int, cfg) -> torch.Tensor:
    """Launch kernel G on a CUDA stack; returns the packed buffer (on the
    card, not synchronized)."""
    p, N, _ = Hp.shape
    _check_window(Hp, n, l, i)
    k = out_len(p, n)
    out = torch.empty(k + 3 * n, dtype=torch.float64, device=Hp.device)
    _launch(Hp, p, n, l, i, its, cfg, out.data_ptr(), _cuda.stream_ptr(Hp))
    return out[:k]
