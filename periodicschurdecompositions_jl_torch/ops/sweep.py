"""One Francis double-shift sweep of the real periodic QR core.

``chase_sweep`` chases the bulge of one double-shift step down the active
window ``[m, i]`` of a ghost-padded ``(p, N, N)`` cycle (N = n + 1), in
place on H (and Z).  Semantics: ``chase_step`` of the JAX package's
``ops/pqr_real.py`` (reference src/PeriodicSchurDecompositions.jl:806-886).

* On a CUDA tensor it launches the three hand-written kernels of
  ``csrc/sweep.cu`` (they replace the Pallas kernels A, B0 and B of the JAX
  package's ``ops/pallas_sweep.py``):

  - ``sweep_generate`` walks k = m..i-1 and generates, in the reference
    order, the bulge reflector of H[0] and the fused 3x3 transform
    F = M3b @ diag(1, M2) of every factor p-1..1, on a working copy of H;
    it writes the log R (p, N, 9);
  - ``sweep_left`` applies the logged F^T to rows k..k+2 of every H[f];
  - ``sweep_right`` applies the logged F to columns k..k+2 of H[f-1]
    (rows 0..i; H[p-1] takes factor 0's log) and of Z[f], and writes the
    structural zeros below the (sub)diagonal exactly.

  Deferring the left and right applications is exact because left and
  right products commute; the reference's forced zeros re-emerge as
  roundoff, which ``sweep_right`` replaces by exact zeros.
* On a CPU tensor it runs ``chase_sweep_plain``, an eager torch port of
  ``chase_step`` (the reference order, with its forced writes).  Any other
  device raises.

``launches`` counts the launches of each kernel.
"""
from __future__ import annotations

import torch

from . import _cuda
from .householder import refl_mat, reflector_small
from .rotations import colsk, rowsk

launches = {"sweep_generate": 0, "sweep_left": 0, "sweep_right": 0}


def chase_sweep_plain(H, Z, m: int, i: int, v0, *, want_z: bool,
                      early: bool = False, log=None):
    """Eager torch sweep in the reference order (in place on H and Z).

    ``early``: dlahqr early start (``allow_early_qr``): the first
    reflector also scales H[0][m, m-1] by (1 - tau).
    ``log``: optional (p, N, 9) tensor that receives the transforms in
    ``sweep_generate``'s layout (factor 0: M3; factor f: M3b @ diag(1, M2)).
    """
    p = H.shape[0]
    dt, dev = H.dtype, H.device
    v0 = torch.as_tensor(v0, dtype=dt, device=dev)
    mask3 = torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    tgt = p - 1 if p > 1 else 0
    for k in range(m, i):
        nr3 = (i - k + 1) >= 3
        hi_r = min(k + 3, i) + 1
        if k > m:
            col = H[0, k:k + 3, k - 1].clone()
            vk = col
        else:
            vk = v0
        if not nr3:
            vk = vk * mask3
        w, tau, beta = reflector_small(vk)
        M3 = refl_mat(w, tau)
        if k > m:
            H[0, k:k + 3, k - 1] = torch.stack(
                [beta, zero, col[2] if k == i - 1 else zero])
        elif early:
            H[0, k, k - 1] *= 1.0 - tau
        rowsk(H[0], k, M3, lo=k)
        colsk(H[tgt], k, M3, hi=hi_r)
        if want_z:
            colsk(Z[0], k, M3)
        if log is not None:
            log[0, k] = M3.reshape(9)
        for f in range(p - 1, 0, -1):
            colv = H[f, k:k + 3, k].clone()
            if not nr3:
                colv = colv * mask3
            w2, tau2, beta2 = reflector_small(colv)
            M3b = refl_mat(w2, tau2)
            H[f, k:k + 3, k] = torch.stack([beta2, zero, zero])
            rowsk(H[f], k, M3b, lo=k + 1)
            colsk(H[f - 1], k, M3b, hi=hi_r)
            if want_z:
                colsk(Z[f], k, M3b)
            F = M3b
            if nr3:
                xc = H[f, k + 1:k + 3, k + 1].clone()
                wb, taub, betab = reflector_small(xc)
                M2 = refl_mat(wb, taub)
                H[f, k + 1:k + 3, k + 1] = torch.stack([betab, zero])
                rowsk(H[f], k + 1, M2, lo=k + 2)
                colsk(H[f - 1], k + 1, M2, hi=hi_r)
                if want_z:
                    colsk(Z[f], k + 1, M2)
                F = M3b.clone()
                F[:, 1:] = M3b[:, 1:] @ M2
            if log is not None:
                log[f, k] = F.reshape(9)
    return H, Z


def apply_log_plain(H, Z, R, m: int, i: int, *, want_z: bool):
    """Plain torch version of ``sweep_left`` + ``sweep_right``: apply a
    (p, N, 9) transform log to H (and Z) in place, left products first,
    then the right products, then the exact structural zeros."""
    p, N, _ = H.shape
    F = R.view(p, N, 3, 3)
    c0 = max(m - 1, 0)
    for k in range(m, i):
        rows = H[:, k:k + 3, c0:]
        new = F[:, k].transpose(1, 2) @ rows
        if k == m and m >= 1:
            new[0, :, 0] = rows[0, :, 0]  # window-boundary column m-1
        rows.copy_(new)
    Fr = torch.roll(F, -1, dims=0)  # H[g] takes the log of factor (g+1) % p
    for k in range(m, i):
        cols = H[:, :i + 1, k:k + 3]
        cols.copy_(cols @ Fr[:, k])
        if want_z:
            zc = Z[:, :, k:k + 3]
            zc.copy_(zc @ F[:, k])
    for r in range(m + 1, i + 1):
        H[0, r, c0:r - 1] = 0.0
        H[1:, r, m:r] = 0.0
    return H, Z


def _check(name, t, shape, dtype=torch.float64):
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def chase_sweep(H, Z, m: int, i: int, v0, *, want_z: bool, early: bool = False):
    """One double-shift sweep over the window [m, i], in place.

    Args:
      H: (p, N, N) float64 ghost-padded stack; H[0] Hessenberg, H[1:]
         upper triangular.
      Z: (p, N, N) float64 Schur vector stack, or None when not wanted.
      m, i: window bounds (host ints); the sweep chases k = m..i-1.
      v0: the normalized first shifted column (3 floats).
      want_z: update Z.
      early: dlahqr early start (scale H[0][m, m-1] by 1 - tau).

    Returns (H, Z).  Entries below the subdiagonal of H[0] and below the
    diagonal of H[1:] within the window are exact zeros on output.
    """
    if H.device.type == "cpu":
        return chase_sweep_plain(H, Z, m, i, v0, want_z=want_z, early=early)
    if H.device.type != "cuda":
        raise ValueError(f"chase_sweep: unsupported device {H.device}")
    p, N, _ = H.shape
    _check("H", H, (p, N, N))
    if want_z:
        _check("Z", Z, (p, N, N))
        if Z.device != H.device:
            raise ValueError("chase_sweep: H and Z on different devices")
    if not (0 <= m <= i <= N - 2):
        raise ValueError(f"chase_sweep: bad window m={m} i={i} for N={N}")
    if i == m:
        return H, Z
    lib = _cuda.load()
    st = _cuda.stream_ptr(H)
    v = [float(x) for x in v0]
    R = torch.empty((p, N, 9), dtype=torch.float64, device=H.device)
    C = torch.empty((p, N, N), dtype=torch.float64, device=H.device)
    _cuda.check(lib.psd_sweep_generate(H.data_ptr(), C.data_ptr(), R.data_ptr(),
                                       p, N, m, i, v[0], v[1], v[2], st),
                "sweep_generate")
    launches["sweep_generate"] += 1
    if early:
        # the first reflector's leading row on column m-1: R[0, m, 0] is
        # exactly 1 - tau (w[0] = 1)
        H[0, m, m - 1] *= R[0, m, 0]
    _cuda.check(lib.psd_sweep_left(H.data_ptr(), R.data_ptr(), p, N, m, i, st),
                "sweep_left")
    launches["sweep_left"] += 1
    _cuda.check(lib.psd_sweep_right(H.data_ptr(),
                                    Z.data_ptr() if want_z else None,
                                    R.data_ptr(), p, N, m, i, st),
                "sweep_right")
    launches["sweep_right"] += 1
    return H, Z
