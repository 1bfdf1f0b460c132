"""The 2x2-deflation branch of the real periodic QR core.

``deflate2x2`` runs ``defl2``'s retriangularization of the JAX package's
``ops/pqr_real.py`` (reference src/PeriodicSchurDecompositions.jl:895-1054)
in place on the ghost-padded H (and Z):

* chainA (``jmin >= 1``): annihilate H[f][i, i-1] from the right across
  factors f <= jmin-2;
* chainB: the lanv2 standardizing rotation (or, after a replacement, a
  Givens rotation of H[0]) followed by one re-triangularizing 2-reflector
  per factor p-1..jmax+1, repeated while the replacement rotation has not
  driven H[0][i, i-1] below ``thr`` (at most 20 rounds); then the forced
  zeros.

The scalars (lanv2's rotation, jmin/jmax, the replacement flag, the final
force-zero flag and the threshold) are computed on the host by the caller.

Without T (the core's ``want_t=False``) the row updates stop before
column ``rhi`` and H's column updates start at row ``clo`` (the JAX core's
``thi``/``tlo``; None: unbounded; Z is never bounded).

On a CUDA tensor it launches the hand-written kernel of ``csrc/deflate.cu``
(it replaces the Pallas kernel D of ``ops/pallas_deflate.py``); on a CPU
tensor it runs ``deflate2x2_plain``, an eager torch port.  ``launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from . import _cuda
from .householder import refl_mat, reflector_small
from .rotations import colsk, givens_real, lmat, rmat_adj, rowsk
from .sweep import _check, check_bounds

launches = {"deflate2x2": 0}


def deflate2x2_plain(H, Z, i: int, jmin: int, jmax: int, cs0: float,
                     sn0: float, replace0: bool, finzero: bool, thr: float, *,
                     want_z: bool, rhi=None, clo=None):
    """Eager torch 2x2-deflation branch (in place on H and Z);
    ``rhi``/``clo``: the want_t=False window (None: unbounded)."""
    p = H.shape[0]
    dt, dev = H.dtype, H.device
    one = torch.ones((), dtype=dt, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    if jmin >= 1:
        # chainA
        for f in range(0, jmin - 1):
            w, tau, beta = reflector_small(torch.stack([H[f, i, i], H[f, i, i - 1]]))
            wv = torch.stack([w[1], one])
            M2 = eye2 - tau * torch.outer(wv, wv)
            H[f, i, i - 1] = 0.0
            H[f, i, i] = beta
            colsk(H[f], i - 1, M2, clo=clo, hi=i)
            rowsk(H[f + 1], i - 1, M2, lo=i - 1, rhi=rhi)
            if want_z:
                colsk(Z[f + 1], i - 1, M2)
        return H, Z
    # chainB
    tgt = p - 1 if p > 1 else 0
    cs0 = torch.as_tensor(cs0, dtype=dt, device=dev)
    sn0 = torch.as_tensor(sn0, dtype=dt, device=dev)
    replace = bool(replace0)
    for _ in range(20):
        if replace:
            c, s, _r = givens_real(H[0, i - 1, i - 1], H[0, i, i - 1])
        else:
            c, s = cs0, sn0
        rowsk(H[0], i - 1, lmat(c, s), lo=i - 1, rhi=rhi)
        colsk(H[tgt], i - 1, rmat_adj(c, s), clo=clo, hi=i + 1)
        if want_z:
            colsk(Z[0], i - 1, rmat_adj(c, s))
        for f in range(p - 1, max(jmax, 0), -1):
            w, tau, beta = reflector_small(torch.stack([H[f, i - 1, i - 1],
                                                        H[f, i, i - 1]]))
            M2 = refl_mat(w, tau)
            H[f, i - 1, i - 1] = beta
            H[f, i, i - 1] = 0.0
            rowsk(H[f], i - 1, M2, lo=i, rhi=rhi)
            colsk(H[f - 1], i - 1, M2, clo=clo, hi=i + 1)
            if want_z:
                colsk(Z[f], i - 1, M2)
        conv = (not replace) or abs(float(H[0, i, i - 1])) < thr
        replace = True
        if conv:
            break
    if finzero:
        H[0, i, i - 1] = 0.0
    if jmax >= 1:
        H[jmax, i, i - 1] = 0.0
    return H, Z


def deflate2x2(H, Z, i: int, jmin: int, jmax: int, cs0: float, sn0: float,
               replace0: bool, finzero: bool, thr: float, *, want_z: bool,
               rhi=None, clo=None):
    """Run the 2x2-deflation branch at rows/columns i-1, i; returns (H, Z).

    Args:
      H, Z: (p, N, N) float64 ghost-padded stacks (Z None when unwanted).
      i: active-window bottom; jmin/jmax: negligible triangular-diagonal
        factor indices (-1 = none); cs0/sn0: the lanv2 rotation;
        replace0: chainB's replacement flag; finzero: force H[0][i, i-1]
        to zero at the end; thr: chainB's convergence threshold
        max(smlnum, ulp * max|lambda|).
      rhi, clo: the want_t=False window (None: unbounded): row updates on
        the columns < rhi (i + 1 <= rhi <= N), H's column updates on the
        rows >= clo (0 <= clo <= i - 1).
    """
    check_bounds("deflate2x2", i - 1, i, H.shape[1], rhi, clo)
    if H.device.type == "cpu":
        return deflate2x2_plain(H, Z, i, jmin, jmax, cs0, sn0, replace0,
                                finzero, thr, want_z=want_z, rhi=rhi, clo=clo)
    if H.device.type != "cuda":
        raise ValueError(f"deflate2x2: unsupported device {H.device}")
    p, N, _ = H.shape
    _check("H", H, (p, N, N))
    if want_z:
        _check("Z", Z, (p, N, N))
    if not (1 <= i <= N - 2):
        raise ValueError(f"deflate2x2: bad row i={i} for N={N}")
    lib = _cuda.load()
    with _cuda.on_device(H):
        _cuda.check(lib.psd_deflate2x2_bounded(
            H.data_ptr(), Z.data_ptr() if want_z else None, p, N, i, int(jmin), int(jmax),
            int(bool(replace0)), int(bool(finzero)), float(cs0), float(sn0), float(thr),
            0 if clo is None else int(clo), N if rhi is None else int(rhi),
            _cuda.stream_ptr(H)), "deflate2x2")
    launches["deflate2x2"] += 1
    return H, Z
