"""Orientation reversal and cyclic relabeling of a decomposition (port of
``utils/circshift.py``)."""
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


def circshift_psd(P, k: int):
    """Cyclically relabel factors: new factor j is old factor (j - k) mod p.

    The new decomposition describes the cycle ``A'[j] = A[(j-k) % p]`` (same
    product up to cyclic rotation of the labels); ``schurindex`` moves to
    ``(schurindex + k) % p``.
    """
    p = P.period
    k = k % p
    if k == 0:
        return P
    ks = (P.schurindex + k) % p
    Zs = None if P.Zs is None else torch.roll(P.Zs, k, dims=0)
    Ts = torch.roll(P.Ts, k, dims=0)
    if isinstance(P, GeneralizedPeriodicSchur):
        S = tuple(P.S[(j - k) % p] for j in range(p))
        return GeneralizedPeriodicSchur(
            S=S, schurindex=ks, Ts=Ts, Zs=Zs, alpha=P.alpha, beta=P.beta,
            alphascale=P.alphascale, orientation=P.orientation)
    return PeriodicSchur(Ts=Ts, Zs=Zs, values=P.values,
                         orientation=P.orientation, schurindex=ks)
