"""The rotation ladders around the real generalized double-shift chase.

``rg_ladder`` runs one of the three single-position rotation ladders of the
real generalized periodic QZ core (the JAX package's exact-f64
``ops/pqz_real.py``), in place on a real ``(p, n, n)`` cycle ``H`` (and the
Schur vectors ``Z``) with signature ``S``:

* ``"open"`` (``act_sweep``'s opening, reference src/rgeneralized.jl:890-943):
  the two opening rotations (c1, s1) on columns j, j+1 and (c2, s2) on
  columns j+1, j+2 of H[0] (rows up to ``ilast``), threaded through every
  factor, ending on the rows of H[0];
* ``"close"`` (the closing rotation, :1015-1048): annihilate H[0][j+1, j-1]
  against H[0][j, j-1], then run ``chain510`` from that rotation;
* ``"chain"`` (``chain510``, :510-540): one rotation (c1, s1) on rows j, j+1
  of H[0], threaded through the factors p-1..1 and back to H[0]'s columns
  (the 2x2 attack's perfect-shift ladder).

``rot`` is a (4,) float64 tensor on H's device, (c1, s1, c2, s2): the host
writes it, the ladder reads it (``"open"`` reads all four, ``"chain"`` the
first two, ``"close"`` none).  ``rhi`` bounds the columns of row updates
and ``clo`` the rows of column updates (the reference's window when
``want_t`` is False; None: unbounded): the entries outside keep their
values, those inside take the values of the unbounded ladder's.

* On a CUDA tensor ``rg_ladder`` launches the hand-written kernel
  ``rg_ladder`` of ``csrc/rgopen.cu`` (it replaces the Pallas kernel R of
  the JAX package's ``ops/pallas_rgopen.py``), one launch per ladder.
* On a CPU tensor it runs the plain version ``rg_ladder_plain``: the f64
  glue of the JAX core, with the rotations generated on the tensor's
  device.  Any other device raises.

``launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _cuda
from .rotations import colsk, givens_real, lmat, rmat_adj, rowsk
from .sweep import _check
from .sweep_cx import _signature

launches = {"rg_ladder": 0}

MODES = {"open": 0, "close": 1, "chain": 2}


def _chain510(H, Z, j, c1, s1, S, want_z, wlo, whi):
    """The single-rotation ladder (reference :1020-1048)."""
    p = H.shape[0]
    rowsk(H[0], j, lmat(c1, s1), lo=j, rhi=whi)
    if want_z:
        colsk(Z[0], j, rmat_adj(c1, s1))
    for l in range(p - 1, 0, -1):
        Hl = H[l]
        if S[l]:
            colsk(Hl, j, rmat_adj(c1, s1), clo=wlo, hi=j + 2)
            c1, s1, r = givens_real(Hl[j, j], Hl[j + 1, j])
            Hl[j, j] = r
            Hl[j + 1, j] = 0.0
            rowsk(Hl, j, lmat(c1, s1), lo=j + 1, rhi=whi)
        else:
            rowsk(Hl, j, lmat(c1, s1), lo=j, rhi=whi)
            c1, s1, r = givens_real(Hl[j + 1, j + 1], -Hl[j + 1, j])
            Hl[j + 1, j + 1] = r
            Hl[j + 1, j] = 0.0
            colsk(Hl, j, rmat_adj(c1, s1), clo=wlo, hi=j + 1)
        if want_z:
            colsk(Z[l], j, rmat_adj(c1, s1))
    colsk(H[0], j, rmat_adj(c1, s1), clo=wlo)


def rg_ladder_plain(H, Z, mode: str, j: int, ilast: int, rot, S: Sequence[bool], *,
                    want_z: bool, rhi=None, clo=None):
    """Plain torch version of kernel R, in place; see the module docstring."""
    p = H.shape[0]
    c1, s1, c2, s2 = torch.as_tensor(rot, dtype=H.dtype, device=H.device)
    if mode == "chain":
        _chain510(H, Z, j, c1, s1, S, want_z, clo, rhi)
        return H, Z
    if mode == "close":
        c1, s1, r1 = givens_real(H[0, j, j - 1], H[0, j + 1, j - 1])
        H[0, j, j - 1] = r1
        H[0, j + 1, j - 1] = 0.0
        _chain510(H, Z, j, c1, s1, S, want_z, clo, rhi)
        return H, Z
    if mode != "open":
        raise ValueError(f"rg_ladder: unknown mode {mode!r}")
    colsk(H[0], j + 1, rmat_adj(c2, s2), clo=clo, hi=ilast + 1)
    colsk(H[0], j, rmat_adj(c1, s1), clo=clo, hi=ilast + 1)
    if want_z:
        colsk(Z[1 % p], j + 1, rmat_adj(c2, s2))
        colsk(Z[1 % p], j, rmat_adj(c1, s1))
    for l in range(1, p):
        Hl = H[l]
        if S[l]:
            rowsk(Hl, j + 1, lmat(c2, s2), lo=j, rhi=rhi)
            c2, s2, r = givens_real(Hl[j + 2, j + 2], -Hl[j + 2, j + 1])
            Hl[j + 2, j + 2] = r
            Hl[j + 2, j + 1] = 0.0
            colsk(Hl, j + 1, rmat_adj(c2, s2), clo=clo, hi=j + 2)
            rowsk(Hl, j, lmat(c1, s1), lo=j, rhi=rhi)
            c1, s1, r = givens_real(Hl[j + 1, j + 1], -Hl[j + 1, j])
            Hl[j + 1, j + 1] = r
            Hl[j + 1, j] = 0.0
            colsk(Hl, j, rmat_adj(c1, s1), clo=clo, hi=j + 1)
        else:
            colsk(Hl, j + 1, rmat_adj(c2, s2), clo=clo, hi=j + 3)
            c2, s2, r = givens_real(Hl[j + 1, j + 1], Hl[j + 2, j + 1])
            Hl[j + 1, j + 1] = r
            Hl[j + 2, j + 1] = 0.0
            rowsk(Hl, j + 1, lmat(c2, s2), lo=j + 2, rhi=rhi)
            colsk(Hl, j, rmat_adj(c1, s1), clo=clo, hi=j + 2)
            c1, s1, r = givens_real(Hl[j, j], Hl[j + 1, j])
            Hl[j, j] = r
            Hl[j + 1, j] = 0.0
            rowsk(Hl, j, lmat(c1, s1), lo=j + 1, rhi=rhi)
        if want_z:
            ln = (l + 1) % p
            colsk(Z[ln], j + 1, rmat_adj(c2, s2))
            colsk(Z[ln], j, rmat_adj(c1, s1))
    rowsk(H[0], j + 1, lmat(c2, s2), lo=j, rhi=rhi)
    rowsk(H[0], j, lmat(c1, s1), lo=j, rhi=rhi)
    return H, Z


def rg_ladder(H, Z, mode: str, j: int, ilast: int, rot, S: Sequence[bool], *,
              want_z: bool, rhi=None, clo=None):
    """One rotation ladder of the real generalized QZ core, in place.

    Args:
      H: (p, n, n) float64 stack; H[0] Hessenberg (with the sweep's bulge),
         H[1:] upper triangular.
      Z: (p, n, n) float64 Schur vectors, or None when not wanted.
      mode: "open" (at j = the window's first row, rows of H[0] up to
         ``ilast``), "close" (at j = ilast - 1) or "chain" (at j).
      rot: (4,) float64 tensor on H's device, (c1, s1, c2, s2).
      S: signature, one bool per factor, S[0] True.
      rhi, clo: want_t=False window bounds (None: unbounded).
    Returns (H, Z).
    """
    _check("rot", rot, (4,))       # a float32 rotation is not orthogonal
    if H.device.type == "cpu":
        return rg_ladder_plain(H, Z, mode, j, ilast, rot, S, want_z=want_z,
                               rhi=rhi, clo=clo)
    if H.device.type != "cuda":
        raise ValueError(f"rg_ladder: unsupported device {H.device}")
    p, n, _ = H.shape
    _check("H", H, (p, n, n))
    if want_z:
        _check("Z", Z, (p, n, n))
    if Z is not None and Z.device != H.device or rot.device != H.device:
        raise ValueError("rg_ladder: H, Z and rot must lie on one device")
    if mode not in MODES:
        raise ValueError(f"rg_ladder: unknown mode {mode!r}")
    if len(S) != p or not S[0] or p < 2:
        raise ValueError("rg_ladder: p >= 2, one signature entry per factor, S[0] True")
    lo_j = 1 if mode == "close" else 0
    hi_j = n - 3 if mode == "open" else n - 2
    if not (lo_j <= j <= hi_j and ilast <= n - 1):
        raise ValueError(f"rg_ladder: bad position j={j} ilast={ilast} for n={n}")
    lib = _cuda.load()
    with _cuda.on_device(H):
        _cuda.check(lib.psd_rg_ladder(H.data_ptr(), Z.data_ptr() if want_z else None,
                                      rot.data_ptr(), _signature(S, H.device).data_ptr(),
                                      p, n, MODES[mode], j, ilast,
                                      n if rhi is None else int(rhi),
                                      0 if clo is None else int(clo),
                                      _cuda.stream_ptr(H)), "rg_ladder")
    launches["rg_ladder"] += 1
    return H, Z
