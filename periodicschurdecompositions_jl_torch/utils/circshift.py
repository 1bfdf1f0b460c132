"""Orientation reversal of a decomposition (port of ``utils/circshift.py``)."""
from __future__ import annotations

import torch

from ..types import GeneralizedPeriodicSchur, PeriodicSchur


def _rev_z(Zs):
    # Z'[0] = Z[0]; Z'[l] = Z[p-l]
    if Zs is None:
        return None
    return torch.roll(torch.flip(Zs, (0,)), 1, dims=0)


def rev_alias(P):
    """Reinterpret a decomposition (PeriodicSchur or
    GeneralizedPeriodicSchur) with the opposite orientation.

    For 'R' with ``Z[j]' A[j] Z[j+1] = T[j]`` the same data is an 'L'
    decomposition of the reversed cycle ``B[l] = A[p-1-l]`` with
    ``T'[l] = T[p-1-l]``, ``Z'[0] = Z[0]``, ``Z'[l] = Z[p-l]``.
    """
    p = P.period
    lorient = "R" if P.orientation == "L" else "L"
    ks = p - 1 - P.schurindex
    if isinstance(P, GeneralizedPeriodicSchur):
        return GeneralizedPeriodicSchur(
            S=tuple(reversed(P.S)), schurindex=ks, Ts=torch.flip(P.Ts, (0,)),
            Zs=_rev_z(P.Zs), alpha=P.alpha, beta=P.beta,
            alphascale=P.alphascale, orientation=lorient)
    return PeriodicSchur(Ts=torch.flip(P.Ts, (0,)), Zs=_rev_z(P.Zs),
                         values=P.values, orientation=lorient, schurindex=ks)
