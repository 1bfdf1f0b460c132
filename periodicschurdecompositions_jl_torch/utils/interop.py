"""State and results carried between the JAX package and this port.

Everything crosses as numpy arrays, so this module imports neither JAX nor
the JAX package; it accepts any object exposing numpy-convertible arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import GeneralizedPeriodicSchur, PartialPeriodicSchur, PeriodicSchur


def state_from_jax_ff(Hhi, Hlo, ZThi=None, ZTlo=None):
    """Float-float (hi, lo) sweep state of the JAX kernels -> float64 tensors.

    ``H = hi + lo`` (exact in float64); Z^T (the JAX kernels keep the Schur
    vectors transposed) is untransposed.  Ghost padding is kept as is.
    Returns (H, Z); Z is None without ZThi.
    """
    H = np.asarray(Hhi, np.float64) + np.asarray(Hlo, np.float64)
    Ht = torch.as_tensor(np.ascontiguousarray(H))
    Zt = None
    if ZThi is not None:
        ZT = np.asarray(ZThi, np.float64) + np.asarray(ZTlo, np.float64)
        Zt = torch.as_tensor(np.ascontiguousarray(np.swapaxes(ZT, -1, -2)))
    return Ht, Zt


def schur_from_jax(P) -> PeriodicSchur:
    """A JAX-package ``PeriodicSchur`` (arrays as numpy) -> this port's."""
    def t(x):
        return None if x is None else torch.as_tensor(np.array(x))
    return PeriodicSchur(Ts=t(P.Ts), Zs=t(P.Zs), values=t(P.values),
                         orientation=P.orientation, schurindex=int(P.schurindex))


def partial_from_jax(P, device="cpu") -> PartialPeriodicSchur:
    """A JAX-package ``PartialPeriodicSchur`` (arrays as numpy) -> this
    port's, its tensors on ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)
    return PartialPeriodicSchur(Ts=t(P.Ts), Vs=t(P.Vs), values=t(P.values),
                                residuals=t(P.residuals), orientation=P.orientation,
                                schurindex=int(P.schurindex))


def mp_from_jax(P):
    """A JAX-package ``MpGeneralizedPeriodicSchur`` (host mpmath arrays) ->
    this port's (the same fields, the arrays copied)."""
    from ..ops.pqz_mp import MpGeneralizedPeriodicSchur
    return MpGeneralizedPeriodicSchur(
        S=tuple(P.S), Ts=np.array(P.Ts, dtype=object),
        Zs=None if P.Zs is None else np.array(P.Zs, dtype=object), alpha=list(P.alpha),
        beta=list(P.beta), alphascale=list(P.alphascale), orientation=P.orientation,
        schurindex=int(P.schurindex), dps=int(P.dps))


def schur_to_numpy(P: PeriodicSchur) -> dict:
    """This port's ``PeriodicSchur`` -> a dict of numpy arrays and metadata,
    the fields of the JAX package's ``PeriodicSchur``."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()
    return {"Ts": a(P.Ts), "Zs": a(P.Zs), "values": a(P.values),
            "orientation": P.orientation, "schurindex": P.schurindex}


def _state(H, Z, dt, device):
    def t(x):
        return torch.tensor(np.asarray(x, dt), device=device)
    return t(H), (None if Z is None else t(Z))


def state_from_jax_cx(H, Z=None, device="cpu"):
    """Complex128 (H, Z) of the JAX package (arrays, numpy-convertible) ->
    contiguous complex128 tensors on ``device``; Z may be None."""
    return _state(H, Z, np.complex128, device)


def state_from_jax_rg(H, Z=None, device="cpu"):
    """Float64 (H, Z) of the JAX package's real generalized core (arrays,
    numpy-convertible) -> contiguous float64 tensors on ``device``; Z may be
    None."""
    return _state(H, Z, np.float64, device)


def gps_from_jax(P, device="cpu") -> GeneralizedPeriodicSchur:
    """A JAX-package ``GeneralizedPeriodicSchur`` -> this port's."""
    def t(x, dt=None):
        return None if x is None else torch.as_tensor(np.array(x, dt), device=device)
    return GeneralizedPeriodicSchur(
        S=tuple(bool(x) for x in P.S), schurindex=int(P.schurindex),
        Ts=t(P.Ts), Zs=t(P.Zs), alpha=t(P.alpha, np.complex128),
        beta=t(P.beta, np.float64), alphascale=t(P.alphascale, np.int32),
        orientation=P.orientation)


def gps_to_numpy(P: GeneralizedPeriodicSchur) -> dict:
    """This port's ``GeneralizedPeriodicSchur`` -> a dict of numpy arrays
    and metadata, the fields of the JAX package's type."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()
    return {"S": tuple(P.S), "schurindex": P.schurindex, "Ts": a(P.Ts),
            "Zs": a(P.Zs), "alpha": a(P.alpha), "beta": a(P.beta),
            "alphascale": a(P.alphascale), "orientation": P.orientation}
