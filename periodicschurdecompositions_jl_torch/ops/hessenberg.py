"""Periodic Hessenberg-triangular reduction (port of ``hessenberg.py``).

``phessenberg_core`` (all direct factors) reduces a cycle ``A[0..p-1]`` by
unitary similarity,

    Q[j]^H A[j] Q[(j+1) % p] = H[j],

with ``H[0]`` upper Hessenberg and ``H[1..p-1]`` upper triangular (MB03VD
column sweep).

* A float64 or complex128 CUDA tensor launches the hand-written reduction
  of ``csrc/hess.cu`` (it replaces the Pallas kernel of the JAX package's
  ``ops/pallas_hess.py``; the complex128 instance is the same kernel over
  complex scalars, where the JAX package reduces in jnp): one cooperative
  launch runs the whole chain of reflector generations and updates, with
  a grid barrier between stages.  The JAX package keeps its kernel off by
  default (``PSD_HESS_KERNEL``) only because it measured no gain over its
  XLA glue on the TPU; that measurement says nothing about this card, so
  here the kernel is the route and there is no switch.  Other dtypes on
  the card raise.
* A CPU tensor takes ``phessenberg_core_plain``: one host loop over
  columns; for each column the p-cycle of reflector generate/apply steps
  runs as torch GEMV/GER updates on the tensors' device.  The generators
  are branch-free, so the loop never reads a value back to the host.  Each
  reflector is zero outside its window, so the rank-1 updates touch only
  the rows (left) or columns (right) of that window; outside it the
  full-width update of the JAX package is an exact no-op.

``launches["hess_reduce"]`` counts the kernel's launches (one per
reduction with n >= 2, either instance), as the C entry points report them.

``phessenberg_signed_core`` handles a mixed signature (Kressner's
two-stage scheme): stage 1, QR/RQ factorizations of the triangular factors
(``torch.linalg.qr``, as the JAX package leaves them to ``jnp.linalg.qr``);
stage 2, Givens chains that reduce H[0] to Hessenberg form while
re-triangularizing the others.

* A float64 or complex128 CUDA tensor runs stage 2 as one launch of
  ``csrc/hess_signed.cu`` (the JAX package computes it in jnp inside its
  jitted core, with no Pallas kernel): one block generates every rotation
  and applies every update on the card, with no read to the host.  Other
  dtypes on the card raise; n <= 2 launches nothing.
* A CPU tensor takes ``phessenberg_signed_core_plain``, whose chains loop
  over the active rotations only (the JAX package runs all n steps with
  masks) and generate each rotation on the host from the two entries it
  annihilates.

``launches["hess_signed"]`` counts the stage-2 kernel's launches (one per
reduction with n > 2, either instance), as the C entry points report them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _cuda
from .householder import refl_left, refl_right, reflector_masked
from .rotations import colsk, givens_host, lmat_host, rmat_adj_host, rowsk
from .sweep_cx import _signature

launches = {"hess_reduce": 0, "hess_signed": 0}


def _scrub(A):
    """Exact zeros outside the Hessenberg-triangular structure."""
    A[0] = torch.triu(A[0], -1)
    if A.shape[0] > 1:
        A[1:] = torch.triu(A[1:])
    return A


def phessenberg_core(A: torch.Tensor, want_q: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce a stacked cycle to periodic Hessenberg/triangular form.

    Args:
      A: (p, n, n) real or complex stack (not modified); on a CUDA device
         it must be float64 or complex128.
      want_q: accumulate the unitary factors.

    Returns:
      (H, Q): H[0] upper Hessenberg, H[1:] upper triangular, with exact
      structural zeros; Q (p, n, n) with Q[j]^H A[j] Q[(j+1)%p] = H[j]
      (None if not requested).
    """
    if A.device.type == "cpu":
        return phessenberg_core_plain(A, want_q)
    if A.device.type != "cuda":
        raise ValueError(f"phessenberg_core: unsupported device {A.device}")
    p, n, n2 = A.shape
    if n != n2:
        raise ValueError("factors must be square")
    if A.dtype not in (torch.float64, torch.complex128):
        raise ValueError(f"phessenberg_core: input on the card must be float64 "
                         f"or complex128, got {A.dtype}")
    H = A.clone(memory_format=torch.contiguous_format)
    Q = torch.eye(n, dtype=H.dtype, device=H.device).expand(p, n, n).clone() \
        if want_q else None
    if n <= 1:
        return H, Q
    ws = torch.empty(n + 2, dtype=H.dtype, device=H.device)
    nlaunch = ctypes.c_int(0)
    lib = _cuda.load()
    entry = lib.psd_hess_reduce_c128 if H.is_complex() else lib.psd_hess_reduce
    with _cuda.on_device(H):
        rc = entry(H.data_ptr(), Q.data_ptr() if want_q else None, ws.data_ptr(), p, n,
                   ctypes.byref(nlaunch), _cuda.stream_ptr(H))
    launches["hess_reduce"] += nlaunch.value
    _cuda.check(rc, "hess_reduce")
    return H, Q


def phessenberg_core_plain(A: torch.Tensor, want_q: bool = True
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch reduction (the CPU route, and the reference the kernel
    is checked against on the card); same contract as ``phessenberg_core``,
    any dtype and device."""
    p, n, n2 = A.shape
    if n != n2:
        raise ValueError("factors must be square")
    A = A.clone()
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Q = eye.expand(p, n, n).clone() if want_q else None
    if n <= 1:
        return A, Q
    for i in range(n - 1):
        # factors p-1 .. 1: triangularize column i
        for j in range(p - 1, 0, -1):
            w, tau, beta = reflector_masked(A[j, :, i], i)
            refl_left(A[j, i:], w[i:], tau.conj())
            A[j, i, i] = beta
            A[j, i + 1:, i] = 0.0
            refl_right(A[j - 1, :, i:], w[i:], tau)
            if want_q:
                refl_right(Q[j, :, i:], w[i:], tau)
        # factor 0: Hessenberg column i (annihilate below row i+1)
        w, tau, beta = reflector_masked(A[0, :, i], i + 1)
        refl_left(A[0, i + 1:], w[i + 1:], tau.conj())
        A[0, i + 1, i] = beta
        A[0, i + 2:, i] = 0.0
        refl_right(A[p - 1, :, i + 1:], w[i + 1:], tau)
        if want_q:
            refl_right(Q[0, :, i + 1:], w[i + 1:], tau)
    return _scrub(A), Q


def _rq(A):
    """RQ decomposition A = R @ Q via a flipped QR (R upper triangular)."""
    B = torch.flip(A, (0,)).conj().T          # B = A^H J
    Q1, R1 = torch.linalg.qr(B)
    R = torch.flip(R1.conj().T, (0, 1))       # J R1^H J
    Q = torch.flip(Q1.conj().T, (0,))         # J Q1^H
    return R, Q


def phessenberg_signed_core(A: torch.Tensor, S: Sequence[bool],
                            want_q: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generalized periodic Hessenberg-triangular reduction (mixed signature).

    Stage 1 triangularizes factors p-1..1 by QR (direct factors) or RQ
    (inverted factors) with ``torch.linalg.qr``, propagating the unitary
    into the neighbour according to its sign; stage 2 reduces factor 0 to
    Hessenberg form with Givens chains, re-triangularizing each factor
    (direct: QR-like rotation, inverted: RQ-like rotation).

    Requires ``S[0]``.  Returns (H, Q) with H[0] Hessenberg, H[1:]
    triangular, ``Q[l]^H A[l] Q[(l+1)%p] = H[l]`` for S[l], else
    ``Q[(l+1)%p]^H A[l] Q[l] = H[l]``.  Real or complex input; on a CUDA
    device it must be float64 or complex128 (stage 2 is one launch of
    ``csrc/hess_signed.cu``).
    """
    if A.device.type == "cpu":
        return phessenberg_signed_core_plain(A, S, want_q)
    if A.device.type != "cuda":
        raise ValueError(f"phessenberg_signed_core: unsupported device {A.device}")
    if A.dtype not in (torch.float64, torch.complex128):
        raise ValueError(f"phessenberg_signed_core: input on the card must be float64 "
                         f"or complex128, got {A.dtype}")
    S = _signature_of(S, A.shape[0])
    sig = _signature(S, A.device)
    A, Q = _signed_stage1(A, S, want_q)
    if A.shape[1] > 2:
        signed_stage2_cuda(A, Q, sig)
    return _scrub(A), Q


def signed_stage2_cuda(H: torch.Tensor, Q: Optional[torch.Tensor],
                       sig: torch.Tensor) -> None:
    """Stage 2 on the card, in place: one launch of ``csrc/hess_signed.cu``
    (no read to the host).  H, Q: stage 1's contiguous (p, n, n) float64 or
    complex128 output (Q may be None); sig: the signature as a device int32
    array (``sweep_cx._signature``).  The kernel updates Q transposed (its
    column updates become row updates, whose loads coalesce)."""
    p, n, _ = H.shape
    lib = _cuda.load()
    cx = H.is_complex()
    ws = torch.empty(lib.psd_hess_signed_scratch(n, int(cx)), dtype=torch.uint8,
                     device=H.device)
    QT = None if Q is None else Q.transpose(1, 2).contiguous()
    entry = lib.psd_hess_signed_c128 if cx else lib.psd_hess_signed
    nlaunch = ctypes.c_int(0)
    with _cuda.on_device(H):
        rc = entry(H.data_ptr(), None if QT is None else QT.data_ptr(), sig.data_ptr(),
                   ws.data_ptr(), p, n, ctypes.byref(nlaunch), _cuda.stream_ptr(H))
    launches["hess_signed"] += nlaunch.value
    _cuda.check(rc, "hess_signed")
    if Q is not None:
        Q.copy_(QT.transpose(1, 2))


def _signature_of(S, p):
    S = tuple(bool(x) for x in S)
    if len(S) != p or not S[0]:
        raise ValueError("signature: one entry per factor, S[0] must be True")
    return S


def _signed_stage1(A, S, want_q):
    """Stage 1 of the signed reduction on a contiguous copy of A: QR / RQ
    of factors p-1..1.  Returns (A, Q)."""
    p, n, _ = A.shape
    A = A.clone(memory_format=torch.contiguous_format)
    Q = torch.eye(n, dtype=A.dtype, device=A.device).expand(p, n, n).clone() \
        if want_q else None
    for l in range(p - 1, 0, -1):
        if S[l]:
            Qf, R = torch.linalg.qr(A[l])
            A[l] = R
            A[l - 1] = A[l - 1] @ Qf if S[l - 1] else Qf.conj().T @ A[l - 1]
            if want_q:
                Q[l] = Q[l] @ Qf
        else:
            R, Qf = _rq(A[l])
            A[l] = R
            A[l - 1] = A[l - 1] @ Qf.conj().T if S[l - 1] else Qf @ A[l - 1]
            if want_q:
                Q[l] = Q[l] @ Qf.conj().T
    return A, Q


def phessenberg_signed_core_plain(A: torch.Tensor, S: Sequence[bool],
                                  want_q: bool = True
                                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch signed reduction (the CPU route, and the reference the
    kernel is checked against on the card); same contract as
    ``phessenberg_signed_core``, any dtype and device."""
    p, n, _ = A.shape
    S = _signature_of(S, p)
    A, Q = _signed_stage1(A, S, want_q)
    if n <= 2:
        return _scrub(A), Q

    # ---- stage 2: Givens Hessenberg reduction of factor 0 ---------------
    # The rotations are generated on the host from the two entries each one
    # annihilates (one read per rotation), in the JAX order.  An operation
    # that no later generation of the same chain reads is deferred to the
    # end of the chain and applied in the original order with the chain's
    # 2x2 matrices sent in one transfer: the row updates of factor 0 and of
    # the direct factors (rows i-1, i from column i on, disjoint from every
    # later column update and generation) and the Q updates.
    dt, dev = A.dtype, A.device

    def mats(G, rng, build):
        return torch.tensor([build(*G[i]) for i in rng], dtype=dt, device=dev)

    for j in range(n - 2):
        rng = range(n - 1, j + 1, -1)          # the active i >= j + 2
        G = {}
        A0 = A[0]
        col = A0[:, j].tolist()                # factor 0 reads column j only
        x = col[n - 1]
        for i in rng:
            c, s, x = givens_host(col[i - 1], x)
            G[i] = (c, s)
        A0[j + 1, j] = x
        A0[j + 2:, j] = 0.0
        L = mats(G, rng, lmat_host)
        R = mats(G, rng, rmat_adj_host)
        for t, i in enumerate(rng):
            rowsk(A0, i - 1, L[t], lo=j + 1)
        if want_q:
            for t, i in enumerate(rng):
                colsk(Q[0], i - 1, R[t])
        for l in range(p - 1, 0, -1):
            Al = A[l]
            Gn = {}
            if S[l]:
                for t, i in enumerate(rng):
                    colsk(Al, i - 1, R[t], hi=i + 1)
                    f, g = Al[i - 1:i + 1, i - 1].tolist()
                    c, s, r = givens_host(f, g)
                    Al[i - 1, i - 1] = r
                    Al[i, i - 1] = 0.0
                    Gn[i] = (c, s)
                Ln = mats(Gn, rng, lmat_host)
                for t, i in enumerate(rng):
                    rowsk(Al, i - 1, Ln[t], lo=i)
            else:
                Lp = mats(G, rng, lmat_host)
                for t, i in enumerate(rng):
                    rowsk(Al, i - 1, Lp[t], lo=i - 1)
                    g, f = Al[i, i - 1:i + 1].tolist()
                    c, s, r = givens_host(f, g)
                    Al[i, i] = r
                    Al[i, i - 1] = 0.0
                    colsk(Al, i - 1, torch.tensor(lmat_host(c, s), dtype=dt,
                                                  device=dev), hi=i)
                    Gn[i] = (c, -s)
            G = Gn
            R = mats(G, rng, rmat_adj_host)
            if want_q:
                for t, i in enumerate(rng):
                    colsk(Q[l], i - 1, R[t])
        for t, i in enumerate(rng):
            colsk(A0, i - 1, R[t])
    return _scrub(A), Q
