"""Result types and typed failures (PyTorch port of ``types.py``).

Same conventions as the JAX package (all indices 0-based):

* right orientation ('R'): ``Z[j]' A[j] Z[(j+1)%p] = T[j]``, representing
  ``A[0] @ A[1] @ ... @ A[p-1]``;
* left orientation ('L'): ``Z[(j+1)%p]' A[j] Z[j] = T[j]``, representing
  ``A[p-1] @ ... @ A[0]``;
* ``schurindex``: the factor in (quasi-)triangular Schur form.

The factor cycle is one stacked ``(p, n, n)`` tensor.  The result types are
plain frozen dataclasses of tensors, subclasses of ``AbstractPeriodicSchur``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


class IllConditionedException(Exception):
    """An operation on a decomposition failed due to ill-conditioning.

    ``info`` may be the index of the eigenvalue associated with the failure.
    """

    def __init__(self, info: int = -1):
        super().__init__(f"ill-conditioned problem (info={info})")
        self.info = info


class PSDNotImplemented(Exception):
    """A requested variant is not implemented (in this port: not yet)."""


class PKSFailure(Exception):
    """Periodic Krylov-Schur failure (reference: src/krylov.jl:20-22)."""


class ConvergenceFailure(Exception):
    """An iteration core failed to converge within its budget."""

    def __init__(self, level: int = -1):
        super().__init__(f"convergence failed at level {level}")
        self.level = level


class AbstractPeriodicSchur:
    """Common base of the periodic Schur factorizations."""

    @property
    def period(self) -> int:
        return int(self.Ts.shape[0])

    @property
    def n(self) -> int:
        return int(self.Ts.shape[-1])

    @property
    def T1(self):
        """The (quasi-)triangular Schur factor (factor ``schurindex``)."""
        return self.Ts[self.schurindex]

    @property
    def T(self):
        """The remaining triangular factors, in cyclic order after T1."""
        p = self.period
        return [self.Ts[(self.schurindex + 1 + i) % p] for i in range(p - 1)]

    @property
    def Z(self):
        """List of the p orthogonal factors (None when not computed)."""
        if self.Zs is None:
            return None
        return [self.Zs[j] for j in range(self.period)]


@dataclasses.dataclass(frozen=True)
class PeriodicSchur(AbstractPeriodicSchur):
    """Periodic Schur factorization of a cycle ``A[0..p-1]``.

    Fields:
      Ts: (p, n, n) stacked factors; ``Ts[schurindex]`` is quasi-triangular,
          all others upper triangular.
      Zs: (p, n, n) stacked orthogonal factors, or None if not requested.
      values: (n,) complex eigenvalues of the cyclic product.
      orientation: 'R' or 'L'.
      schurindex: the factor carrying the quasi-triangular Schur form.
    """

    Ts: torch.Tensor
    Zs: Optional[torch.Tensor]
    values: torch.Tensor
    orientation: str = "R"
    schurindex: int = 0


@dataclasses.dataclass(frozen=True)
class GeneralizedPeriodicSchur(AbstractPeriodicSchur):
    """Generalized periodic Schur factorization of ``prod_j A[j]^{s[j]}``.

    Fields:
      S: tuple of bool; True: the factor enters the product directly,
         False: it enters inverted.
      schurindex: index of the triangular Schur factor.
      Ts, Zs: stacked factors as in PeriodicSchur (Zs unitary); for real
          input Ts[schurindex] is quasi-triangular, with a 2x2 block per
          complex pair.
      alpha: (n,) complex128 scaled eigenvalue numerators, |alpha| in
          [1, 2) or 0.
      beta: (n,) float64; 1, or 0 for an infinite eigenvalue.
      alphascale: (n,) int32 power-of-two exponents.
      orientation: 'R' or 'L'.
    """

    S: Tuple[bool, ...]
    schurindex: int
    Ts: torch.Tensor
    Zs: Optional[torch.Tensor]
    alpha: torch.Tensor
    beta: torch.Tensor
    alphascale: torch.Tensor
    orientation: str = "R"

    @property
    def period(self) -> int:
        return len(self.S)

    @property
    def values(self):
        """Eigenvalues ``alpha / beta * 2^alphascale`` (inf when beta == 0)."""
        rdt = self.alpha.real.dtype
        two = torch.tensor(2.0, dtype=rdt, device=self.alpha.device)
        return self.alpha / self.beta.to(rdt) * two ** self.alphascale.to(rdt)


@dataclasses.dataclass(frozen=True)
class PartialPeriodicSchur(AbstractPeriodicSchur):
    """Partial periodic Schur decomposition from ``partial_pschur``.

    Left orientation only (like the reference, src/krylov.jl:98-147):
    ``A[l] V[l] = V[(l+1) % p] T[l]`` column-wise for the leading ``k``
    columns, with ``T[p-1]`` (the "Schur" slot) quasi-triangular.

    Fields:
      Ts: (p, k, k) small projected factors.
      Vs: (p, n, k) stacked orthonormal bases.
      values: (k,) complex128 converged eigenvalue estimates of the product.
      residuals: (k,) float64 residual estimates for each eigenvalue.
    """

    Ts: torch.Tensor
    Vs: torch.Tensor
    values: torch.Tensor
    residuals: torch.Tensor
    orientation: str = "L"
    schurindex: int = 0

    @property
    def Q(self):
        return [self.Vs[j] for j in range(self.period)]
