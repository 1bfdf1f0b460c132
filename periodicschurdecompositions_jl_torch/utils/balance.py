"""Periodic cycle balancing: exact power-of-two diagonal similarities
(port of ``utils/balance.py``).

The reference leaves balancing unimplemented (`_rebalance!` is a
commented-out TODO at the reference's src/ordschur.jl:67 and
src/rordschur.jl:114); this is the cycle analogue of LAPACK xGEBAL's
Parlett-Reinsch scaling, provided as a host-side pre-conditioner.

For a cycle ``A_0 .. A_{p-1}`` (right orientation: the decomposition is
``Q_l' A_l Q_{l+1} = T_l``), balancing picks diagonal matrices ``D_l`` of
EXACT powers of two and transforms

    Ab_l = D_l^{-1} A_l D_{l+1}        (indices mod p),

which is a similarity of every cyclic product: for any slot ``l``,
``prod_l(Ab) = D_l^{-1} prod_l(A) D_l`` — eigenvalues are preserved
EXACTLY (power-of-two scaling commits no rounding), while graded row/
column norms are equalized so the QR iteration's rotation generation and
deflation thresholds operate on comparable magnitudes.

The condition balanced per (slot, index) pair mirrors Parlett-Reinsch: the
1-norm of column ``i`` of ``Ab_{l-1}`` (everything flowing INTO position
(l, i) of the cycle graph) is matched against the 1-norm of row ``i`` of
``Ab_l`` (everything flowing OUT) by a power of two, sweeping until no
scale changes (gebal's convergence argument carries over: each update
strictly reduces sum of column*row norm products by >= the classic 0.95^2
factor).

Usage:

    Ab, D = balance_pcycle(A)      # tensors on A's device
    P = pschur(Ab, 'R')
    # eigenvalues: P.values ARE the eigenvalues of the original product.
    # Schur vectors relate by the (non-orthogonal) diagonal similarity:
    # the exact invariant-subspace basis of prod_l(A) is D_l @ Z_l[:, :k].
    # eigvecs: v_l(original) = D_l @ v_l(balanced), renormalized.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.drivers import _target

__all__ = ["balance_pcycle"]


def balance_pcycle(A, max_sweeps: int = 30, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balance a periodic cycle by exact power-of-two diagonal similarity.

    The sweeps are a serial chain of p n dependent power-of-two decisions,
    so they run on the host, as in the JAX package: the cycle comes to the
    host in one copy, and the result is bit for bit the JAX package's.

    Args:
      A: (p, n, n) real or complex cycle (right orientation): a tensor
        (the result goes back to its device) or an array (to ``device``,
        default ``"cuda"``; without a card pass ``device="cpu"``).
      max_sweeps: sweep budget (convergence is typically < 10 sweeps).

    Returns:
      (Ab, D): the balanced cycle, and the (p, n) positive scale tensor of
      exact powers of two with ``Ab[l] = diag(1/D[l]) @ A[l] @ diag(D[l+1])``.
      Products satisfy ``prod_l(Ab) = diag(1/D[l]) prod_l(A) diag(D[l])``.
    """
    if isinstance(A, torch.Tensor):
        dev = A.device if device is None else _target(device)
        An = A.detach().cpu().numpy()
    else:
        dev = _target(device)
        An = np.asarray(A)
    Ab, D = _balance_np(An, max_sweeps)
    return torch.as_tensor(Ab).to(dev), torch.as_tensor(D).to(dev)


def _balance_np(A: np.ndarray, max_sweeps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's numpy sweeps, unchanged."""
    A = np.asarray(A)
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"need a (p, n, n) cycle, got {A.shape}")
    p, n, _ = A.shape
    Ab = A.copy()
    D = np.ones((p, n), A.real.dtype)
    if n == 1:
        return Ab, D
    # gebal's factor: scale by 2 while it reduces c*r by >= (1 - 5%)
    GAMMA = 0.95
    for _ in range(max_sweeps):
        changed = False
        for l in range(p):
            lm = (l - 1) % p
            for i in range(n):
                # inflow: column i of Ab[l-1] (excl. diagonal when l-1 == l,
                # i.e. p == 1: the classic same-matrix exclusion)
                col = np.abs(Ab[lm][:, i]).sum()
                row = np.abs(Ab[l][i, :]).sum()
                if p == 1:
                    d = abs(Ab[l][i, i])
                    col -= d
                    row -= d
                if col == 0.0 or row == 0.0:
                    continue  # exact decoupling: leave it to deflation
                f = 1.0
                c, r = col, row
                # gebal-style sfmin/sfmax guard: keep the scale (and the
                # scaled norms) far from the f64 range ends
                FMAX, FMIN = 2.0 ** 512, 2.0 ** -512
                while c < r / 2.0 and f < FMAX:
                    c *= 2.0
                    r /= 2.0
                    f *= 2.0
                while c >= r * 2.0 and f > FMIN:
                    c /= 2.0
                    r *= 2.0
                    f /= 2.0
                if f != 1.0 and (c + r) < GAMMA * (col + row):
                    # scale position (l, i): D[l][i] *= f means column i of
                    # Ab[l-1] *= f and row i of Ab[l] /= f
                    D[l][i] *= f
                    Ab[lm][:, i] *= f
                    Ab[l][i, :] /= f
                    changed = True
        if not changed:
            break
    return Ab, D
