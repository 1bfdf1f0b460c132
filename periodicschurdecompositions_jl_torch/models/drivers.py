"""Public decomposition drivers (port of ``models/drivers.py``).

Ported: ``pschur`` for real and complex input, with or without a
signature (both orientations), ``gpschur`` for real and complex pairs, and
``phessenberg`` with or without a signature; ``pschur`` and ``gpschur``
with ``want_t`` True or False.

Device rule: a torch tensor is computed on its own device (a CPU tensor is
an explicit request for the CPU).  An array or a sequence of matrices goes
to ``device``, by default ``"cuda"``; without a CUDA card that raises
unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.hessenberg import phessenberg_core, phessenberg_signed_core
from ..types import GeneralizedPeriodicSchur, PeriodicSchur


def _target(device):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: arrays are computed on the card by default; pass "
            "device=\"cpu\" (or a CPU tensor) to compute on the CPU")
    return dev


def _stack(A, device=None) -> torch.Tensor:
    """A (p, n, n) float64 or complex128 tensor from a stacked tensor/array
    or a sequence of matrices.

    A tensor, or a sequence of tensors, keeps its device unless ``device``
    is given.  An array or a sequence holding arrays goes to ``device``,
    by default ``"cuda"``; with no card that raises unless ``device="cpu"``.
    """
    if isinstance(A, torch.Tensor):
        T = A if device is None else A.to(_target(device))
    elif not hasattr(A, "ndim") and len(A) and all(isinstance(a, torch.Tensor)
                                                   for a in A):
        T = torch.stack(list(A))
        T = T if device is None else T.to(_target(device))
    else:
        dev = _target(device)
        arr = np.asarray(A) if hasattr(A, "ndim") else np.stack(
            [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
             for a in A])
        T = torch.as_tensor(arr).to(dev)
    if T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"expected a (p, n, n) cycle, got shape {tuple(T.shape)}")
    return T.to(torch.complex128 if T.is_complex() else torch.float64)


def _char_lr(lr) -> str:
    s = str(lr).lstrip(":").upper()
    if s not in ("R", "L"):
        raise ValueError("orientation must be 'R' (right) or 'L' (left)")
    return s


BACKENDS = ("auto", "f64", "complex")  # the port's one route
TPU_BACKENDS = ("ff", "split")  # the JAX package's tiers for a TPU without f64


def _check_backend(backend):
    if backend in BACKENDS:
        return
    if backend in TPU_BACKENDS:
        raise ValueError(
            f"backend={backend!r}: the float-float ('ff') and split-complex "
            f"('split') tiers exist only in the JAX package, for a TPU without "
            f"float64 or complex types; the port computes in float64 / complex128 "
            f"(backend='auto', 'f64' or 'complex')")
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS + TPU_BACKENDS}")


def phessenberg(A, S: Optional[Sequence[bool]] = None, want_q: bool = True, *,
                device=None):
    """Periodic Hessenberg(-triangular) reduction of a real or complex cycle.

    Returns (H, Q): H[0] upper Hessenberg, H[1:] upper triangular, with
    ``Q[l]^H A[l] Q[(l+1)%p] = H[l]`` (direct factors) or
    ``Q[(l+1)%p]^H A[l] Q[l] = H[l]`` (inverted factors, when ``S`` given;
    ``S[0]`` must be True).  ``device``: see the module docstring.
    """
    A = _stack(A, device)
    if S is None or all(bool(x) for x in S):
        return phessenberg_core(A, want_q=want_q)
    return phessenberg_signed_core(A, tuple(bool(x) for x in S), want_q=want_q)


def pschur(A, lr="R", S: Optional[Sequence[bool]] = None, *,
           want_t: bool = True, want_z: bool = True,
           maxitfac: Optional[int] = None, aggressive: bool = False,
           backend: str = "auto", device=None):
    """Periodic (generalized) Schur decomposition of a matrix cycle.

    Args:
      A: (p, n, n) cycle (tensor, array, or sequence of matrices), computed
         in float64 (real) or complex128 (complex).  A tensor is computed on
         its own device; an array goes to ``device`` (default ``"cuda"``;
         without a card pass ``device="cpu"``).  On a CUDA device the
         Hessenberg reduction of direct factors, the real iteration's per-iteration glue, the
         sweeps, the 2x2 deflation, the complex shift and the real
         generalized chase and its ladders run as hand-written CUDA kernels.
         The real, real generalized (p >= 2) and complex iterations take
         aggressive early deflation and the host-tail finish of the
         default ``AlgoConfig`` (``ops/pqr_real.py::pqr_real_core_aed``,
         ``ops/pqz_real.py::pqz_real_gen_core_aed``,
         ``ops/pqz_complex.py::pqz_complex_core_aed``; their window
         analyses run on the host, the window re-reductions on the
         tensor's device).
      lr: 'R' for the product ``A[0] @ ... @ A[p-1]``, 'L' for
          ``A[p-1] @ ... @ A[0]``.
      S: optional signature (True = direct, False = inverted factor); the
         generalized decomposition.
      want_t/want_z: keep the triangular/unitary factors.  With
          ``want_t=False`` every update stays inside the iteration's active
          window (the reference's eigenvalues-only mode): the eigenvalues and
          Z are those of the run with T, and T is valid on its diagonal
          blocks only (``check_psd`` does not hold for it).
      maxitfac: iteration budget factor (default 120 for real input with
          ``S``, else 30).
      aggressive: fixed per-factor deflation thresholds (the real
          generalized decomposition only; ValueError otherwise).
      backend: the JAX package's routing keyword.  "auto", "f64" and
          "complex" all take the port's one route (float64 / complex128);
          "ff" and "split", the JAX package's float-float and split-complex
          tiers for a TPU without f64 or complex types, raise ValueError.

    Returns:
      PeriodicSchur (S is None) or GeneralizedPeriodicSchur (S given).
    """
    _check_backend(backend)
    A = _stack(A, device)
    orient = _char_lr(lr)
    mif = 30 if maxitfac is None else int(maxitfac)
    if aggressive and (S is None or A.is_complex()):
        # the reference defines aggressive deflation for the real
        # generalized decomposition only (src/rgeneralized.jl:7)
        raise ValueError("aggressive deflation applies to the real "
                         "generalized decomposition (real dtype + S) only")
    if A.is_complex():
        from ..ops.pqz_complex import pschur_complex_pipeline
        Sb = (True,) * A.shape[0] if S is None else tuple(bool(x) for x in S)
        gps = pschur_complex_pipeline(A, Sb, orient, want_t=want_t,
                                      want_z=want_z, maxitfac=mif)
        if S is not None:
            return gps
        return PeriodicSchur(Ts=gps.Ts, Zs=gps.Zs, values=gps.values,
                             orientation=gps.orientation,
                             schurindex=gps.schurindex)
    if S is not None:
        from ..ops.pqz_real import pschur_real_gen_pipeline
        return pschur_real_gen_pipeline(
            A, tuple(bool(x) for x in S), orient, want_t=want_t, want_z=want_z,
            maxitfac=120 if maxitfac is None else int(maxitfac),
            aggressive=aggressive)
    from ..ops.pqr_real import pschur_real_pipeline
    return pschur_real_pipeline(A, orient, want_t=want_t, want_z=want_z,
                                maxitfac=mif)


def gpschur(As, Bs, **kwargs) -> GeneralizedPeriodicSchur:
    """GPSD of the formal product ``B[p-1]^-1 A[p-1] ... B[0]^-1 A[0]``.

    Interleaves the pairs into a length-2p signed cycle (terms shifted by
    one, which does not change eigenvalues), as the JAX package's
    ``gpschur``.  Real or complex pairs; ``kwargs`` go to ``pschur``
    (``lr`` defaults to 'R').
    """
    As, Bs = list(As), list(Bs)
    ph = len(As)
    ib = 0 if ph == 1 else ph - 2
    Cs = [As[ph - 1], Bs[ib]]
    Ss = [True, False]
    for j in range(ph - 2, -1, -1):
        Cs.append(As[j])
        Cs.append(Bs[ph - 1 if j == 0 else j - 1])
        Ss.extend([True, False])
    C = _stack(Cs, kwargs.pop("device", None))
    return pschur(C, kwargs.pop("lr", "R"), S=tuple(Ss), **kwargs)
