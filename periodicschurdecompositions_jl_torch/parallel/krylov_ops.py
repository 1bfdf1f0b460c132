"""The device-resident cycle of ``partial_pschur`` on one device (the
one-card counterpart of the JAX package's ``ShardedCycleOps``, without a
mesh).

The operator applications are the only O(n^2)-per-step work of the Krylov
path; everything else is O(k^2 p) host bookkeeping (reference
src/krylov.jl:266,327).  ``CycleOps`` keeps the factor stack (or the
matrix-free operators) and a mirror of the Arnoldi bases on one device, and
runs each step's operator application and iterated classical Gram-Schmidt
there as torch ops.  The host receives only the projection coefficients,
the norm and the in-span flag, in one read per step, and each accepted
column in one more read: the host basis stays the source of truth of the
restart logic, and any host repair reloads the mirror (``load_basis``).

The mirror is kept transposed, one basis vector per row, so that a column
is contiguous and both products of the projection are matrix-vector
products on contiguous memory.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class CycleOps:
    """A cycle of p operators on one device with the Arnoldi basis mirror.

    Args:
      A: a (p, n, n) float64 or complex128 tensor, or a sequence of p
        callables, each mapping a 1-D tensor of length n on ``device`` to
        one there.
      n, dtype, device: needed for callables (``dtype`` a torch dtype);
        taken from the tensor otherwise.

    ``reads`` counts the reads from the device to the host (each a
    synchronisation).
    """

    def __init__(self, A, n: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                 device=None):
        if isinstance(A, torch.Tensor):
            self._A, self._ops = A, None
            self.p, self.n = int(A.shape[0]), int(A.shape[-1])
            self.dtype, self.device = A.dtype, A.device
        else:
            self._A, self._ops = None, list(A)
            self.p, self.n = len(self._ops), int(n)
            self.dtype, self.device = dtype, torch.device(device)
        self._Vt = None      # per slot: (width, n) mirror, row j = basis column j
        self._pending = None
        self.reads = 0

    def _apply(self, l: int, u: torch.Tensor) -> torch.Tensor:
        if self._ops is None:
            return torch.mv(self._A[l], u)
        return torch.as_tensor(self._ops[l](u), dtype=self.dtype, device=self.device)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        self.reads += 1
        return t.cpu().numpy()

    # -- basis mirror management (the host basis is the source of truth) --
    def load_basis(self, V: Sequence[np.ndarray]) -> None:
        """Refresh the device mirrors from the host basis list."""
        self._Vt = [torch.as_tensor(np.ascontiguousarray(v.T)).to(self.device) for v in V]

    def set_col(self, l: int, j: int, col) -> None:
        self._Vt[l][j] = torch.as_tensor(col).to(self.device)

    def get_col(self, l: int, j: int) -> np.ndarray:
        return self._read(self._Vt[l][j])

    # -- one Arnoldi step on the device --------------------------------------
    def apply_orth(self, l: int, lnext: int, j: int, ncols: int, eta: float):
        """v = A[l] @ V[l][:, j], CGS-orthogonalized against
        V[lnext][:, :ncols], with the eta-test re-pass.

        Both candidates (one pass and two) are computed and one is picked
        with ``torch.where``, as the JAX package's traced ``lax.cond``
        does, so no norm is read to branch.  Returns (h, w, inspan) from
        one read; the vector waits on the device for ``accept``."""
        U = self._Vt[lnext][:ncols]
        v = self._apply(l, self._Vt[l][j])
        rnorm = torch.linalg.vector_norm(v)
        h1 = torch.mv(U.conj(), v)
        v1 = v - torch.mv(U.T, h1)
        w1 = torch.linalg.vector_norm(v1)
        corr = torch.mv(U.conj(), v1)
        v2 = v1 - torch.mv(U.T, corr)
        w2 = torch.linalg.vector_norm(v2)
        repass = w1 < eta * rnorm
        h = torch.where(repass, h1 + corr, h1)
        w = torch.where(repass, w2, w1)
        inspan = w <= eta * torch.where(repass, w1, rnorm)
        self._pending = torch.where(repass, v2, v1)
        out = self._read(torch.cat([h, torch.stack([w, inspan.to(w.dtype)]).to(h.dtype)]))
        return out[:ncols], float(out[ncols].real), bool(out[ncols + 1].real != 0)

    def apply_norm(self, l: int, j: int) -> float:
        """v = A[l] @ V[l][:, j] with no orthogonalization (the j == 0
        case); returns its norm."""
        self._pending = self._apply(l, self._Vt[l][j])
        return float(self._read(torch.linalg.vector_norm(self._pending)))

    def accept(self, lnext: int, j: int, w: float) -> np.ndarray:
        """Normalize the pending vector into V[lnext][:, j]; returns the
        host copy of the accepted column."""
        col = self._pending / w
        self._Vt[lnext][j] = col
        return self._read(col)

