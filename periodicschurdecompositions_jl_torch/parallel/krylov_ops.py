"""The device-resident cycle of ``partial_pschur``: on one device
(``CycleOps``), and row-sharded over a mesh (``ShardedCycleOps``,
``sharded_dense_ops``: the JAX package's ``parallel/krylov_ops.py``).

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

Sharded: every factor is split by row blocks over the devices of a mesh
(``parallel.mesh.make_mesh``; one process, peer copies), and so are the
basis mirrors.  A matvec computes the local (n/D, n) @ (n,) block on each
device; the Gram-Schmidt coefficients are the sums of the shards' partial
products, gathered on the home device (the mesh's first); the pending
vector stays sharded.  The host still reads (h, w, inspan) once and each
accepted column once per application.  Shards are copies even where two
entries of the mesh name one device, so D entries on one card (or on the
CPU) take the same path as D cards.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import make_mesh


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



def _row_blocks(n: int, devices) -> list:
    D = len(devices)
    if n % D != 0:
        raise ValueError(f"n={n} not divisible by mesh size {D}")
    L = n // D
    return [slice(d * L, (d + 1) * L) for d in range(D)]


def _factors(A, home):
    if isinstance(A, torch.Tensor):
        T = A
    else:
        T = torch.as_tensor(np.asarray(A)).to(home)
    if T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"expected a (p, n, n) cycle, got shape {tuple(T.shape)}")
    return T.to(torch.complex128 if T.is_complex() else torch.float64)


def sharded_dense_ops(A, mesh: Optional[Sequence] = None):
    """Row-shard a (p, n, n) cycle over ``mesh`` (default: every card) and
    return matvec callables.

    Returns (ops, n, dtype): ``ops[l]`` maps an (n,) tensor to ``A[l] @ v``
    on the mesh's first device (each device computes its row block, the
    blocks are gathered there); for ``partial_pschur(ops, nev, which, n=n,
    dtype=dtype, device=mesh[0])``.  n must be divisible by the mesh size.
    """
    devices = make_mesh(devices=mesh)
    home = devices[0]
    A = _factors(A, home)
    p, n, _ = A.shape
    rows = _row_blocks(n, devices)
    shards = [A[:, r].to(dev, copy=True) for r, dev in zip(rows, devices)]

    def make_op(l):
        def op(v):
            v = torch.as_tensor(v, dtype=A.dtype)
            return torch.cat([(S[l] @ v.to(dev, copy=True)).to(home)
                              for S, dev in zip(shards, devices)])
        return op

    return [make_op(l) for l in range(p)], n, A.dtype


class ShardedCycleOps(CycleOps):
    """``CycleOps`` with the factors and the basis mirrors split by row
    blocks over the devices of ``mesh`` (default: every card); the home
    device, where the coefficients are summed and the results of
    ``partial_pschur`` land, is the mesh's first.  n must be divisible by
    the mesh size (ValueError)."""

    def __init__(self, A, mesh: Optional[Sequence] = None):
        devices = make_mesh(devices=mesh)
        home = devices[0]
        A = _factors(A, home)
        super().__init__(A)
        self.device = home
        self._A = None
        self.devices = devices
        self._rows = _row_blocks(self.n, devices)
        self._shards = [A[:, r].to(dev, copy=True) for r, dev in zip(self._rows, devices)]

    def _split(self, x: torch.Tensor) -> list:
        """Row blocks of ``x`` (last axis n) on their devices, as copies."""
        return [x[..., r].to(dev, copy=True).contiguous()
                for r, dev in zip(self._rows, self.devices)]

    def _gather(self, parts) -> torch.Tensor:
        return torch.cat([q.to(self.device) for q in parts], dim=-1)

    def _sum(self, parts) -> torch.Tensor:
        out = parts[0].to(self.device, copy=True)
        for q in parts[1:]:
            out = out + q.to(self.device)
        return out

    def _bcast(self, x: torch.Tensor) -> list:
        return [x.to(dev, copy=True) for dev in self.devices]

    def _matvec(self, l: int, u: torch.Tensor) -> list:
        """The shards of A[l] @ u, u whole on the home device."""
        return [S[l] @ uu for S, uu in zip(self._shards, self._bcast(u))]

    @staticmethod
    def _sq(v: torch.Tensor) -> torch.Tensor:
        return (v.conj() * v).real.sum()

    # -- basis mirror management ------------------------------------------------
    def load_basis(self, V: Sequence[np.ndarray]) -> None:
        self._Vt = [self._split(torch.as_tensor(np.ascontiguousarray(v.T))) for v in V]

    def set_col(self, l: int, j: int, col) -> None:
        for S, part in zip(self._Vt[l], self._split(torch.as_tensor(col))):
            S[j] = part

    def get_col(self, l: int, j: int) -> np.ndarray:
        return self._read(self._gather([S[j] for S in self._Vt[l]]))

    # -- one Arnoldi step -------------------------------------------------------
    def apply_orth(self, l: int, lnext: int, j: int, ncols: int, eta: float):
        """``CycleOps.apply_orth`` on the shards: each device projects its
        rows, the partial coefficients and squared norms are summed on the
        home device and sent back; one read of (h, w, inspan)."""
        Us = [S[:ncols] for S in self._Vt[lnext]]
        v = self._matvec(l, self._gather([S[j] for S in self._Vt[l]]))
        rnorm = torch.sqrt(self._sum([self._sq(x) for x in v]))
        h1 = self._sum([torch.mv(U.conj(), x) for U, x in zip(Us, v)])
        v1 = [x - torch.mv(U.T, hh) for U, x, hh in zip(Us, v, self._bcast(h1))]
        w1 = torch.sqrt(self._sum([self._sq(x) for x in v1]))
        corr = self._sum([torch.mv(U.conj(), x) for U, x in zip(Us, v1)])
        v2 = [x - torch.mv(U.T, c) for U, x, c in zip(Us, v1, self._bcast(corr))]
        w2 = torch.sqrt(self._sum([self._sq(x) for x in v2]))
        repass = w1 < eta * rnorm
        h = torch.where(repass, h1 + corr, h1)
        w = torch.where(repass, w2, w1)
        inspan = w <= eta * torch.where(repass, w1, rnorm)
        self._pending = [torch.where(r, b, a) for r, a, b in zip(self._bcast(repass), v1, v2)]
        out = self._read(torch.cat([h, torch.stack([w, inspan.to(w.dtype)]).to(h.dtype)]))
        return out[:ncols], float(out[ncols].real), bool(out[ncols + 1].real != 0)

    def apply_norm(self, l: int, j: int) -> float:
        self._pending = self._matvec(l, self._gather([S[j] for S in self._Vt[l]]))
        return float(self._read(torch.sqrt(self._sum([self._sq(x) for x in self._pending]))))

    def accept(self, lnext: int, j: int, w: float) -> np.ndarray:
        cols = [x / w for x in self._pending]
        for S, c in zip(self._Vt[lnext], cols):
            S[j] = c
        return self._read(self._gather(cols))
