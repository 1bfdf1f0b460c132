"""The double-shift chase of the real generalized periodic QZ core.

``rg_chase`` runs the chase steps j = m..i-2 of one double-shift sweep of
the JAX package's exact-f64 ``ops/pqz_real.py`` (``act_sweep``'s
``chase_step``, reference src/rgeneralized.jl:953-1014) in place on a real
``(p, n, n)`` cycle H (and the Schur vectors Z) with signature ``S``.  The
sweep's opening has left the bulge in column m-1 of H[0] (rows m..m+2);
the chase moves it down to the closing bulge H[0][i, i-2], which it keeps
for the closing ladder (``ops/rgopen.py``).  Per step and factor two
rotation pairs propagate: (c2, s2) on rows/columns j+1, j+2 and (c1, s1) on
j, j+1.

* On a CUDA tensor ``rg_chase`` launches the hand-written kernels of
  ``csrc/sweep_rg.cu`` (they replace the Pallas kernels rg A, B0 and B of
  the JAX package's ``ops/pallas_sweep_rg.py``):

  - ``rg_sweep_generate`` generates, in the reference order, every
    rotation of the chase; it reads H only (look-ahead windows in shared
    memory, a 2 p n scratch) and writes the log (p, n, 28): per (factor,
    step) the fused left 3x3 L (rows j..j+2), the fused right 3x3 R
    (columns j..j+2 of H[l]) and the fused ZR (columns j..j+2 of Z[l]), and
    for factor 0 the regenerated H[0][j, j-1];
  - ``rg_sweep_left`` applies every logged L to rows j..j+2 of H[l];
  - ``rg_sweep_right`` applies every logged R to columns j..j+2 of H[l]
    (rows 0..i) and ZR to Z[l], then writes the structural zeros of the
    window and the regenerated entries exactly, keeping the closing bulge.
* On a CPU tensor it runs the plain version ``rg_chase_plain`` (the
  interleaved reference order; with ``log=`` it is kernel rg A's plain
  version).  Any other device raises.  ``rg_sweep_generate`` runs kernel
  rg A alone and returns its log.

``rg_apply_log_plain`` is the plain version of kernels B0 + B: it replays a
log in their deferred order.  Without T (the core's ``want_t=False``) the
row updates stop before column ``rhi`` and H's column updates start at
row ``clo`` (the JAX core's ``rhi``/``clo``: ilast + 1 and the sweep's
first row ifirst = m - 1; None: unbounded; Z is never bounded).
``launches`` counts the launches of each kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _cuda
from .rotations import colsk, givens_real, lmat, rmat_adj, rowsk
from .sweep import _check, check_bounds
from .sweep_cx import _signature

launches = {"rg_sweep_generate": 0, "rg_sweep_left": 0, "rg_sweep_right": 0}

LOG = 28  # float64 entries per (factor, step) in a chase log


def fuse_left(c1, s1, c2, s2):
    """E1(c1, s1) @ E2(c2, s2): lmat(c2, s2) on rows 1, 2 acts first, then
    lmat(c1, s1) on rows 0, 1."""
    z = torch.zeros_like(c1)
    return torch.stack([torch.stack([c1, s1 * c2, s1 * s2]),
                        torch.stack([-s1, c1 * c2, c1 * s2]),
                        torch.stack([z, -s2, c2])])


def fuse_right(c1, s1, c2, s2):
    """R2e(c2, s2) @ R1e(c1, s1): rmat_adj(c2, s2) on columns 1, 2 acts
    first, then rmat_adj(c1, s1) on columns 0, 1."""
    z = torch.zeros_like(c1)
    return torch.stack([torch.stack([c1, -s1, z]),
                        torch.stack([c2 * s1, c2 * c1, -s2]),
                        torch.stack([s2 * s1, s2 * c1, c2])])


def _put(log, l, j, at, M):
    if log is not None:
        log[l, j, at:at + 9] = M.reshape(9)


def rg_chase_plain(H, Z, m: int, i: int, S: Sequence[bool], *, want_z: bool, log=None,
                   rhi=None, clo=None):
    """Eager torch chase j = m..i-2 in the reference (interleaved) order, in
    place.  ``log``: optional (p, n, 28) float64 tensor that receives the
    rotations in ``rg_sweep_generate``'s layout; ``rhi``/``clo``: the
    want_t=False window (None: unbounded)."""
    p, n, _ = H.shape
    H0 = H[0]
    for j in range(m, i - 1):
        c2, s2, r2 = givens_real(H0[j + 1, j - 1], H0[j + 2, j - 1])
        c1, s1, r1 = givens_real(H0[j, j - 1], r2)
        H0[j, j - 1] = r1
        H0[j + 1, j - 1] = 0.0
        H0[j + 2, j - 1] = 0.0
        rowsk(H0, j + 1, lmat(c2, s2), lo=j, rhi=rhi)
        rowsk(H0, j, lmat(c1, s1), lo=j, rhi=rhi)
        if want_z:
            colsk(Z[0], j + 1, rmat_adj(c2, s2))
            colsk(Z[0], j, rmat_adj(c1, s1))
        if log is not None:
            _put(log, 0, j, 0, fuse_left(c1, s1, c2, s2))
            _put(log, 0, j, 18, fuse_right(c1, s1, c2, s2))
            log[0, j, 27] = r1
        for l in range(p - 1, 0, -1):
            Hl = H[l]
            if S[l]:
                colsk(Hl, j + 1, rmat_adj(c2, s2), clo=clo, hi=j + 3)
                c2n, s2n, r = givens_real(Hl[j + 1, j + 1], Hl[j + 2, j + 1])
                Hl[j + 1, j + 1] = r
                Hl[j + 2, j + 1] = 0.0
                rowsk(Hl, j + 1, lmat(c2n, s2n), lo=j + 2, rhi=rhi)
                colsk(Hl, j, rmat_adj(c1, s1), clo=clo, hi=j + 2)
                c1n, s1n, r = givens_real(Hl[j, j], Hl[j + 1, j])
                Hl[j, j] = r
                Hl[j + 1, j] = 0.0
                rowsk(Hl, j, lmat(c1n, s1n), lo=j + 1, rhi=rhi)
                L, R = fuse_left(c1n, s1n, c2n, s2n), fuse_right(c1, s1, c2, s2)
            else:
                rowsk(Hl, j + 1, lmat(c2, s2), lo=j, rhi=rhi)
                c2n, s2n, r = givens_real(Hl[j + 2, j + 2], -Hl[j + 2, j + 1])
                Hl[j + 2, j + 1] = 0.0
                Hl[j + 2, j + 2] = r
                colsk(Hl, j + 1, rmat_adj(c2n, s2n), clo=clo, hi=j + 2)
                rowsk(Hl, j, lmat(c1, s1), lo=j, rhi=rhi)
                c1n, s1n, r = givens_real(Hl[j + 1, j + 1], -Hl[j + 1, j])
                Hl[j + 1, j] = 0.0
                Hl[j + 1, j + 1] = r
                colsk(Hl, j, rmat_adj(c1n, s1n), clo=clo, hi=j + 1)
                L, R = fuse_left(c1, s1, c2, s2), fuse_right(c1n, s1n, c2n, s2n)
            c1, s1, c2, s2 = c1n, s1n, c2n, s2n
            if want_z:
                colsk(Z[l], j + 1, rmat_adj(c2, s2))
                colsk(Z[l], j, rmat_adj(c1, s1))
            if log is not None:
                _put(log, l, j, 0, L)
                _put(log, l, j, 9, R)
                _put(log, l, j, 18, fuse_right(c1, s1, c2, s2))
        lm = min(j + 3, n - 1)
        colsk(H0, j + 1, rmat_adj(c2, s2), clo=clo, hi=lm + 1)
        colsk(H0, j, rmat_adj(c1, s1), clo=clo, hi=lm + 1)
        if log is not None:
            _put(log, 0, j, 9, fuse_right(c1, s1, c2, s2))
    return H, Z


def rg_apply_log_plain(H, Z, log, m: int, i: int, *, want_z: bool, rhi=None, clo=None):
    """Plain torch version of ``rg_sweep_left`` + ``rg_sweep_right``: apply a
    (p, n, 28) chase log to H (and Z) in place, the left products first
    (rows j..j+2 from column m-1 on, landing on the columns < rhi), then
    the right products (H rows 0..i, landing on the rows >= clo; Z all
    rows), each with the values of the unbounded update, then the window's
    exact structural zeros (the closing bulge H[0][i, i-2] kept) and the
    logged H[0][j, j-1] (inside any want_t=False window; ``rhi``/``clo``
    None: unbounded)."""
    p, n, _ = H.shape
    if i - 2 < m:
        return H, Z
    L = log[:, :, 0:9].reshape(p, n, 3, 3)
    R = log[:, :, 9:18].reshape(p, n, 3, 3)
    ZR = log[:, :, 18:27].reshape(p, n, 3, 3)
    nc = n - m + 1 if rhi is None else rhi - m + 1
    rlo = 0 if clo is None else clo
    for j in range(m, i - 1):
        rows = H[:, j:j + 3, m - 1:]
        rows[..., :nc].copy_((L[:, j] @ rows)[..., :nc])
    for j in range(m, i - 1):
        cols = H[:, :i + 1, j:j + 3]
        cols[:, rlo:].copy_((cols @ R[:, j])[:, rlo:])
        if want_z:
            zc = Z[:, :, j:j + 3]
            zc.copy_(zc @ ZR[:, j])
    for r in range(m, i + 1):
        H[0, r, m - 1:(r - 1 if r < i else i - 2)] = 0.0   # (i, i-2) kept
        H[1:, r, m - 1:r] = 0.0
    for j in range(m, i - 1):
        H[0, j, j - 1] = log[0, j, 27]
    return H, Z


def rg_chase(H, Z, m: int, i: int, S: Sequence[bool], *, want_z: bool, rhi=None,
             clo=None):
    """The chase steps j = m..i-2 of one double-shift sweep, in place.

    Args:
      H: (p, n, n) float64 stack after the sweep's opening: H[0] Hessenberg
         with the bulge in column m-1 (rows m..m+2), H[1:] upper triangular;
         H[0][i+1, i] must be zero (a deflated boundary).
      Z: (p, n, n) float64 Schur vectors, or None when not wanted.
      m, i: host ints, 1 <= m and i <= n-1; no step runs when i - 2 < m.
      S: signature, one bool per factor, S[0] True.
      rhi, clo: the want_t=False window (None: unbounded): row updates on
         the columns < rhi (i + 1 <= rhi <= n), H's column updates on the
         rows >= clo (0 <= clo <= m - 1); entries outside stay as they were.

    Returns (H, Z).  Entries below the subdiagonal of H[0] and below the
    diagonal of H[1:] in rows m..i are exact zeros on output, except the
    closing bulge H[0][i, i-2].
    """
    check_bounds("rg_chase", m, i, H.shape[1], rhi, clo, clo_max=m - 1)
    if H.device.type == "cpu":
        return rg_chase_plain(H, Z, m, i, S, want_z=want_z, rhi=rhi, clo=clo)
    _check_card_args("rg_chase", H, Z, m, i, S, want_z)
    if i - 2 < m:
        return H, Z
    p, n, _ = H.shape
    lib = _cuda.load()
    st = _cuda.stream_ptr(H)
    log = _generate(lib, st, H, m, i, S)
    with _cuda.on_device(H):
        _cuda.check(lib.psd_rg_sweep_left_bounded(H.data_ptr(), log.data_ptr(), p, n, m, i,
                                                  n if rhi is None else int(rhi), st),
                    "rg_sweep_left")
        launches["rg_sweep_left"] += 1
        _cuda.check(lib.psd_rg_sweep_right_bounded(H.data_ptr(),
                                                   Z.data_ptr() if want_z else None,
                                                   log.data_ptr(), p, n, m, i,
                                                   0 if clo is None else int(clo), st),
                    "rg_sweep_right")
    launches["rg_sweep_right"] += 1
    return H, Z


def _check_card_args(name, H, Z, m, i, S, want_z):
    """Raise ValueError unless H (and Z) are float64 (p, n, n) stacks on one
    CUDA device, S a signature of them and [m, i] a window."""
    if H.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {H.device}")
    p, n, _ = H.shape
    _check("H", H, (p, n, n))
    if want_z:
        _check("Z", Z, (p, n, n))
        if Z.device != H.device:
            raise ValueError(f"{name}: H and Z on different devices")
    if len(S) != p or not S[0] or p < 2:
        raise ValueError(f"{name}: p >= 2, one signature entry per factor, S[0] True")
    if not (1 <= m and i <= n - 1):
        raise ValueError(f"{name}: bad window m={m} i={i} for n={n}")


def rg_sweep_generate(H, m: int, i: int, S: Sequence[bool]):
    """Kernel rg A alone: the rotation log (p, n, 28) of the chase steps
    m..i-2 (m <= i-2) on the CUDA stack H, which it reads only (those steps
    of the log are written).  Its scratch is the two carried rows (2 p n
    float64), plus the windows when p is too large for them to fit in
    shared memory.  On a CPU tensor: the log of ``rg_chase_plain`` on a copy
    of H (zeros where the kernel writes nothing)."""
    if H.device.type == "cpu":
        log = torch.zeros((*H.shape[:2], LOG), dtype=torch.float64)
        rg_chase_plain(H.clone(), None, m, i, S, want_z=False, log=log)
        return log
    _check_card_args("rg_sweep_generate", H, None, m, i, S, False)
    if i - 2 < m:
        raise ValueError("rg_sweep_generate: no chase step in the window")
    return _generate(_cuda.load(), _cuda.stream_ptr(H), H, m, i, S)


def _generate(lib, st, H, m, i, S):
    p, n, _ = H.shape
    with _cuda.on_device(H):
        nwork = lib.psd_rg_sweep_generate_scratch(p, n)
        if nwork < 0:
            raise RuntimeError("rg_sweep_generate: CUDA error reading the card's shared "
                               "memory limit")
        work = torch.empty(nwork, dtype=torch.float64, device=H.device)
        log = torch.empty((p, n, LOG), dtype=torch.float64, device=H.device)
        _cuda.check(lib.psd_rg_sweep_generate(H.data_ptr(), work.data_ptr(), log.data_ptr(),
                                              _signature(S, H.device).data_ptr(), p, n,
                                              m, i, st), "rg_sweep_generate")
    launches["rg_sweep_generate"] += 1
    return log
