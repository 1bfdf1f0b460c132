"""One single-shift sweep of the complex periodic QZ core, and its shift.

``qz_sweep`` chases one single-shift QZ step down the active window
``[m, i]`` of a ``(p, n, n)`` complex128 cycle with signature ``S``, in
place on H (and Z).  ``qz_shift`` computes the sweep's shift rotation
(c, s).  Semantics: ``act_sweep`` of the JAX package's
``ops/pqz_complex.py`` (reference src/generalized.jl:763-852).

* On a CUDA tensor they launch the hand-written kernels of
  ``csrc/sweep_cx.cu`` (they replace the Pallas kernels A, B0, B and S of
  the JAX package's ``ops/pallas_sweep_cx.py``):

  - ``qz_sweep_generate`` walks k = m..i-1 and generates, in the reference
    order, the chase rotation of H[0] and the re-triangularizing rotation
    of every factor p-1..1; it reads H only (look-ahead windows in shared
    memory, a p n scratch) and writes the log (p, n, 16): per (factor,
    step) the left 2x2 L, the right 2x2 R, the Z update ZR, and for factor
    0 the regenerated subdiagonal entry r;
  - ``qz_sweep_left`` applies every logged L to rows k, k+1 of H[l];
  - ``qz_sweep_right`` applies every logged R to columns k, k+1 of H[l]
    (rows 0..i) and ZR to Z[l], then writes the structural zeros and the
    regenerated subdiagonal exactly;
  - ``qz_shift`` computes (c, s) into a device buffer that
    ``qz_sweep_generate`` reads, so no host read sits between them.
* On a CPU tensor they run the plain versions ``qz_sweep_plain`` (the
  interleaved reference order; with ``log=`` it is kernel A's plain
  version) and ``qz_shift_plain``.  Any other device raises.
  ``qz_sweep_generate`` runs kernel A alone and returns its log.

``qz_apply_log_plain`` is the plain version of kernels B0 + B: it replays
a log in their deferred order.  Without T (the core's ``want_t=False``)
the row updates stop before column ``rhi`` and H's column updates start at
row ``clo`` (the JAX core's ``rhi``/``clo``: ilast + 1 and jlo; None:
unbounded; Z is never bounded).  ``launches`` counts the launches of each
kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _cuda, sweep
from .rotations import colsk, givens_complex, lmat, rmat_adj, rowsk
from .sweep import check_bounds

launches = {"qz_sweep_generate": 0, "qz_sweep_left": 0, "qz_sweep_right": 0,
            "qz_shift": 0}

LOG = 16  # complex128 entries per (factor, step) in a sweep log

_sig_cache: dict = {}


def _signature(S: Sequence[bool], dev) -> torch.Tensor:
    """The signature as a device int32 array (cached per signature/device)."""
    key = (tuple(bool(x) for x in S), str(dev))
    t = _sig_cache.get(key)
    if t is None:
        t = torch.tensor([int(x) for x in key[0]], dtype=torch.int32, device=dev)
        if t.is_cuda:
            # other threads' streams read it: its copy must be done first
            torch.cuda.current_stream(t.device).synchronize()
        _sig_cache[key] = t
    return t


def _put(log, l, k, at, M):
    if log is not None:
        log[l, k, at:at + 4] = M.reshape(4)


def qz_sweep_plain(H, Z, m: int, i: int, cs, S: Sequence[bool], *,
                   want_z: bool, log=None, rhi=None, clo=None):
    """Eager torch sweep in the reference (interleaved) order, in place.

    ``cs``: (2,) complex tensor, the shift rotation (c + 0j, s).
    ``log``: optional (p, n, 16) complex tensor that receives the rotations
    in ``qz_sweep_generate``'s layout.  ``rhi``/``clo``: the want_t=False
    window (None: unbounded).
    """
    p, n, _ = H.shape
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    c, s = cs[0].real, cs[1]
    for k in range(m, i):
        if k > m:
            c, s, r = givens_complex(H[0, k, k - 1], H[0, k + 1, k - 1])
            H[0, k, k - 1] = r
            H[0, k + 1, k - 1] = zero
            if log is not None:
                log[0, k, 12] = r
        L = lmat(c, s)
        rowsk(H[0], k, L, lo=k, rhi=rhi)
        ZR = rmat_adj(c, s)
        if want_z:
            colsk(Z[0], k, ZR)
        _put(log, 0, k, 0, L)
        _put(log, 0, k, 8, ZR)
        for l in range(p - 1, 0, -1):
            if S[l]:
                R = rmat_adj(c, s)
                colsk(H[l], k, R, clo=clo, hi=k + 2)
                c, s, r = givens_complex(H[l, k, k], H[l, k + 1, k])
                H[l, k, k] = r
                H[l, k + 1, k] = zero
                L = lmat(c, s)
                rowsk(H[l], k, L, lo=k + 1, rhi=rhi)
            else:
                L = lmat(c, s)
                rowsk(H[l], k, L, lo=k, rhi=rhi)
                cn, sn, r = givens_complex(H[l, k + 1, k + 1], H[l, k + 1, k])
                H[l, k + 1, k] = zero
                H[l, k + 1, k + 1] = r
                R = lmat(cn, sn)
                colsk(H[l], k, R, clo=clo, hi=k + 1)
                c, s = cn, -sn
            ZR = rmat_adj(c, s)
            if want_z:
                colsk(Z[l], k, ZR)
            _put(log, l, k, 0, L)
            _put(log, l, k, 4, R)
            _put(log, l, k, 8, ZR)
        R = rmat_adj(c, s)
        colsk(H[0], k, R, clo=clo, hi=min(k + 3, n))
        _put(log, 0, k, 4, R)
    return H, Z


def qz_apply_log_plain(H, Z, log, m: int, i: int, *, want_z: bool, rhi=None, clo=None):
    """Plain torch version of ``qz_sweep_left`` + ``qz_sweep_right``: apply a
    (p, n, 16) sweep log to H (and Z) in place, left products first (rows
    k, k+1 from column m on, landing on the columns < rhi), then the right
    products (H rows 0..i, landing on the rows >= clo; Z all rows), each
    with the values of the unbounded update, then the exact structural
    zeros and the logged subdiagonal (inside any want_t=False window;
    ``rhi``/``clo`` None: unbounded)."""
    p, n, _ = H.shape
    L = log[:, :, 0:4].reshape(p, n, 2, 2)
    R = log[:, :, 4:8].reshape(p, n, 2, 2)
    ZR = log[:, :, 8:12].reshape(p, n, 2, 2)
    nc = n - m if rhi is None else rhi - m
    rlo = 0 if clo is None else clo
    for k in range(m, i):
        rows = H[:, k:k + 2, m:]
        rows[..., :nc].copy_((L[:, k] @ rows)[..., :nc])
    for k in range(m, i):
        cols = H[:, :i + 1, k:k + 2]
        cols[:, rlo:].copy_((cols @ R[:, k])[:, rlo:])
        if want_z:
            zc = Z[:, :, k:k + 2]
            zc.copy_(zc @ ZR[:, k])
    for r in range(m + 1, i + 1):
        H[0, r, m:r - 1] = 0.0
        H[1:, r, m:r] = 0.0
    for k in range(m + 1, i):
        H[0, k, k - 1] = log[0, k, 12]
    return H, Z


def qz_shift_plain(H, ifirst: int, ilast: int, S: Sequence[bool]):
    """The shift rotation of one sweep (``act_sweep``'s chain), as a (2,)
    complex tensor (c + 0j, s) on H's device."""
    p = H.shape[0]
    one = torch.ones((), dtype=H.dtype, device=H.device)
    c, s, _ = givens_complex(one, one)
    for l in range(p - 1, 0, -1):
        hf = H[l, ifirst, ifirst]
        hl = H[l, ilast, ilast]
        if S[l]:
            c, s, _ = givens_complex(hf * c, hl * s.conj())
        else:
            c, s, _ = givens_complex(hl * c, -hf * s.conj())
            s = -s
    h0f = H[0, ifirst, ifirst]
    h0l = H[0, ilast, ilast]
    h0sub = H[0, ifirst + 1, ifirst]
    c, s, _ = givens_complex(h0f * c - h0l * s.conj(), h0sub * c)
    return torch.stack([c.to(H.dtype), s])


def _check(name, t, shape):
    sweep._check(name, t, shape, torch.complex128)


def _device_kind(H, what):
    if H.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {H.device}")
    return H.device.type


def qz_sweep(H, Z, m: int, i: int, cs, S: Sequence[bool], *, want_z: bool, rhi=None,
             clo=None):
    """One single-shift QZ sweep over the window [m, i], in place.

    Args:
      H: (p, n, n) complex128 stack; H[0] Hessenberg, H[1:] upper
         triangular; H[0][i+1, i] must be zero (a deflated boundary).
      Z: (p, n, n) complex128 Schur vector stack, or None when not wanted.
      m, i: window bounds (host ints); the sweep chases k = m..i-1.
      cs: (2,) complex128 tensor on H's device, the shift rotation
          (c + 0j, s) (``qz_shift``'s output or an exceptional shift).
      S: signature, one bool per factor, S[0] True.
      want_z: update Z.
      rhi, clo: the want_t=False window (None: unbounded): row updates on
         the columns < rhi (i + 1 <= rhi <= n), H's column updates on the
         rows >= clo (0 <= clo <= m); entries outside stay as they were.

    Returns (H, Z).  Entries below the subdiagonal of H[0] and below the
    diagonal of H[1:] within the window are exact zeros on output.
    """
    check_bounds("qz_sweep", m, i, H.shape[1], rhi, clo)
    if _device_kind(H, "qz_sweep") == "cpu":
        return qz_sweep_plain(H, Z, m, i, cs, S, want_z=want_z, rhi=rhi, clo=clo)
    _check_card_args("qz_sweep", H, Z, m, i, cs, S, want_z)
    if i == m:
        return H, Z
    p, n, _ = H.shape
    lib = _cuda.load()
    st = _cuda.stream_ptr(H)
    log = _generate(lib, st, H, m, i, cs, S)
    with _cuda.on_device(H):
        _cuda.check(lib.psd_qz_sweep_left_bounded(H.data_ptr(), log.data_ptr(), p, n, m, i,
                                                  n if rhi is None else int(rhi), st),
                    "qz_sweep_left")
        launches["qz_sweep_left"] += 1
        _cuda.check(lib.psd_qz_sweep_right_bounded(H.data_ptr(),
                                                   Z.data_ptr() if want_z else None,
                                                   log.data_ptr(), p, n, m, i,
                                                   0 if clo is None else int(clo), st),
                    "qz_sweep_right")
    launches["qz_sweep_right"] += 1
    return H, Z


def _check_card_args(name, H, Z, m, i, cs, S, want_z):
    """Raise ValueError unless H (and Z, cs) are complex128 stacks on H's
    CUDA device, S a signature of them and [m, i] a window."""
    p, n, _ = H.shape
    _check("H", H, (p, n, n))
    _check("cs", cs, (2,))
    if want_z:
        _check("Z", Z, (p, n, n))
        if Z.device != H.device:
            raise ValueError(f"{name}: H and Z on different devices")
    if cs.device != H.device:
        raise ValueError(f"{name}: cs must lie on H's device")
    if len(S) != p or not S[0]:
        raise ValueError(f"{name}: one signature entry per factor, S[0] True")
    if not (0 <= m <= i <= n - 1):
        raise ValueError(f"{name}: bad window m={m} i={i} for n={n}")


def qz_sweep_generate(H, m: int, i: int, cs, S: Sequence[bool]):
    """Kernel A alone: the rotation log (p, n, 16) of the sweep over [m, i]
    (m < i) on the CUDA stack H, which it reads only (steps m..i-1 of the
    log are written).  Its scratch is the carried row (p n complex128),
    plus the windows when p is too large for them to fit in shared
    memory.  On a CPU tensor: the log of ``qz_sweep_plain`` on a copy of H
    (zeros where the kernel writes nothing)."""
    if _device_kind(H, "qz_sweep_generate") == "cpu":
        log = torch.zeros((*H.shape[:2], LOG), dtype=torch.complex128)
        qz_sweep_plain(H.clone(), None, m, i, cs, S, want_z=False, log=log)
        return log
    _check_card_args("qz_sweep_generate", H, None, m, i, cs, S, False)
    if i == m:
        raise ValueError("qz_sweep_generate: empty window")
    return _generate(_cuda.load(), _cuda.stream_ptr(H), H, m, i, cs, S)


def _generate(lib, st, H, m, i, cs, S):
    p, n, _ = H.shape
    with _cuda.on_device(H):
        nwork = lib.psd_qz_sweep_generate_scratch(p, n)
        if nwork < 0:
            raise RuntimeError("qz_sweep_generate: CUDA error reading the card's shared "
                               "memory limit")
        work = torch.empty(nwork, dtype=torch.complex128, device=H.device)
        log = torch.empty((p, n, LOG), dtype=torch.complex128, device=H.device)
        _cuda.check(lib.psd_qz_sweep_generate(H.data_ptr(), work.data_ptr(),
                                              log.data_ptr(), cs.data_ptr(),
                                              _signature(S, H.device).data_ptr(),
                                              p, n, m, i, st), "qz_sweep_generate")
    launches["qz_sweep_generate"] += 1
    return log


def qz_shift(H, ifirst: int, ilast: int, S: Sequence[bool], out=None):
    """The shift rotation (c + 0j, s) of a sweep over [ifirst, ilast], as a
    (2,) complex128 tensor on H's device (written into ``out`` if given)."""
    if _device_kind(H, "qz_shift") == "cpu":
        cs = qz_shift_plain(H, ifirst, ilast, S)
        return cs if out is None else out.copy_(cs)
    p, n, _ = H.shape
    _check("H", H, (p, n, n))
    if len(S) != p or not S[0]:
        raise ValueError("qz_shift: one signature entry per factor, S[0] True")
    if not (0 <= ifirst < ilast <= n - 1):
        raise ValueError(f"qz_shift: bad window {ifirst}, {ilast} for n={n}")
    if out is None:
        out = torch.empty(2, dtype=torch.complex128, device=H.device)
    _check("out", out, (2,))
    lib = _cuda.load()
    with _cuda.on_device(H):
        _cuda.check(lib.psd_qz_shift(H.data_ptr(), out.data_ptr(),
                                     _signature(S, H.device).data_ptr(), p, n,
                                     ifirst, ilast, _cuda.stream_ptr(H)),
                    "qz_shift")
    launches["qz_shift"] += 1
    return out
