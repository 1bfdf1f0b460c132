"""Checkpoint / resume: decompositions and Krylov restart state in .npz
archives (port of ``utils/io.py``).

The files carry the JAX package's keys, so a file written by either package
loads in the other.  Saving brings each tensor to the host in one copy;
loading puts the tensors on ``device`` (the drivers' rule: default
``"cuda"``, which raises without a card unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.drivers import _target
from ..types import GeneralizedPeriodicSchur, PartialPeriodicSchur, PeriodicSchur

_KINDS = {
    "PeriodicSchur": PeriodicSchur,
    "GeneralizedPeriodicSchur": GeneralizedPeriodicSchur,
    "PartialPeriodicSchur": PartialPeriodicSchur,
}


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_decomposition(path: str, P) -> None:
    """Save a PeriodicSchur, GeneralizedPeriodicSchur or
    PartialPeriodicSchur to ``path`` (.npz)."""
    kind = type(P).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot save objects of type {kind}")
    data = {"kind": np.asarray(kind), "orientation": np.asarray(P.orientation),
            "schurindex": np.asarray(P.schurindex)}
    if isinstance(P, GeneralizedPeriodicSchur):
        data.update(S=np.asarray(P.S), Ts=_host(P.Ts), alpha=_host(P.alpha),
                    beta=_host(P.beta), alphascale=_host(P.alphascale))
    elif isinstance(P, PartialPeriodicSchur):
        data.update(Ts=_host(P.Ts), Vs=_host(P.Vs), values=_host(P.values),
                    residuals=_host(P.residuals))
    else:
        data.update(Ts=_host(P.Ts), values=_host(P.values))
    if not isinstance(P, PartialPeriodicSchur) and P.Zs is not None:
        data["Zs"] = _host(P.Zs)
    np.savez_compressed(path, **data)


def load_decomposition(path: str, device=None):
    """Load a decomposition saved by :func:`save_decomposition` (of either
    package), its tensors on ``device``."""
    dev = _target(device)

    def t(f, key):
        return torch.as_tensor(f[key]).to(dev) if key in f else None

    with np.load(path) as f:
        kind = str(f["kind"])
        orientation = str(f["orientation"])
        schurindex = int(f["schurindex"])
        if kind == "GeneralizedPeriodicSchur":
            return GeneralizedPeriodicSchur(
                S=tuple(bool(x) for x in f["S"]), schurindex=schurindex,
                Ts=t(f, "Ts"), Zs=t(f, "Zs"), alpha=t(f, "alpha"), beta=t(f, "beta"),
                alphascale=t(f, "alphascale"), orientation=orientation)
        if kind == "PartialPeriodicSchur":
            return PartialPeriodicSchur(
                Ts=t(f, "Ts"), Vs=t(f, "Vs"), values=t(f, "values"),
                residuals=t(f, "residuals"), orientation=orientation,
                schurindex=schurindex)
        return PeriodicSchur(Ts=t(f, "Ts"), Zs=t(f, "Zs"), values=t(f, "values"),
                             orientation=orientation, schurindex=schurindex)


# ---------------------------------------------------------------------------
# Krylov restart checkpointing


def save_krylov_state(path: str, V, B, meta: dict) -> None:
    """Checkpoint a ``partial_pschur`` restart loop.

    ``V``/``B`` are the host Krylov basis / projected-factor lists (numpy,
    per-slot shapes differ); ``meta`` carries the scalar loop state (it, k,
    active, nlock, nprods, p, n, maxdim, dtype, the RNG state as a string,
    lams_all, rs_all).
    """
    data = {}
    for l, v in enumerate(V):
        data[f"V{l}"] = np.asarray(v)
    for l, b in enumerate(B):
        data[f"B{l}"] = np.asarray(b)
    for key, val in meta.items():
        data[f"meta_{key}"] = np.asarray(val)
    np.savez_compressed(path, **data)


def load_krylov_state(path: str):
    """Load a checkpoint saved by :func:`save_krylov_state`.

    Returns (V, B, meta): lists of numpy arrays plus the scalar dict.
    """
    with np.load(path) as f:
        meta = {name[5:]: f[name][()] for name in f.files if name.startswith("meta_")}
        V, B = [], []
        while f"V{len(V)}" in f.files:
            V.append(f[f"V{len(V)}"])
        while f"B{len(B)}" in f.files:
            B.append(f[f"B{len(B)}"])
    return V, B, meta
