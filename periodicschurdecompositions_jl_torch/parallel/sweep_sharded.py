"""The double-shift sweep with its applications sharded over devices (the
JAX package's ``parallel/sweep_sharded.py``, in float64; its float-float
arithmetic is not ported).

A sweep's three stages (``ops/sweep.py``):

* generation (kernel A) is a sequential chain: it runs once, on the home
  device (H's), and its (p, N, 9) log is copied to the other devices (the
  JAX package replicates it on every device instead);
* left application (B0): every column of H is independent, so each device
  applies the log to its column shard of H (``sweep_left_shard``);
* right application (B): every row of H and Z is independent, so each
  device applies the log to its row shards of H and Z
  (``sweep_right_shard``), which also writes the structural zeros of its
  rows by global index.

H and Z are whole on the home device on entry and on exit: per sweep H
goes out and back twice (column shards, then row shards) and Z once.  One
process drives the devices; shards are copies even where two entries of
the mesh name one device, so D shards on one card (or on the CPU, where
the plain versions run) take the same path as D cards.  On the card this
moves more bytes than B0 and B take (~0.1 ms a sweep at p=16 n=512), and
the home device holds the whole stack besides its shard: the path is for
parity with the JAX package only, neither for speed nor for stacks larger
than one device holds.

N = n + 1 (the ghost-padded lane count) must be divisible by the number of
shards, as the JAX package asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import sweep as _sweep
from .mesh import make_mesh


def _check_shards(N: int, D: int) -> int:
    if N % D != 0:
        raise ValueError(f"the mesh size ({D}) must divide the lane count N={N} (n + 1); "
                         "pad the cycle")
    return N // D


def chase_sweep_sharded(H, Z, m: int, i: int, v0, *, devices: Sequence, want_z: bool,
                        early: bool = False, rhi=None, clo=None):
    """One double-shift sweep over [m, i] with sharded applications, in
    place on H (and Z): the contract of ``ops.sweep.chase_sweep`` (same
    arguments; ``devices``: the mesh, one entry per shard).  Returns (H, Z)."""
    p, N, _ = H.shape
    devices = make_mesh(devices=devices)
    L = _check_shards(N, len(devices))
    _sweep.check_bounds("chase_sweep_sharded", m, i, N, rhi, clo)
    if i == m:
        return H, Z
    R = _sweep.sweep_generate(H, m, i, v0)  # kernel A, on the home device
    if early:
        # the first reflector's leading row on column m-1: R[0, m, 0] = 1 - tau
        H[0, m, m - 1] *= R[0, m, 0]
    logs = [R.to(dev, copy=True) for dev in devices]
    chi = N if rhi is None else int(rhi)
    c_lo = max(m - 1, 0)
    # B0 on column shards
    parts = []
    for d, dev in enumerate(devices):
        c0 = d * L
        if min(chi, c0 + L) <= max(c_lo, c0):
            continue  # no column of the shard takes the left products
        Hc = H[:, :, c0:c0 + L].to(dev, copy=True).contiguous()
        parts.append((c0, _sweep.sweep_left_shard(Hc, logs[d], m, i, c0, rhi=rhi)))
    for c0, Hc in parts:
        H[:, :, c0:c0 + L] = Hc.to(H.device)
    # B on row shards
    parts = []
    for d, dev in enumerate(devices):
        r0 = d * L
        Hr = H[:, r0:r0 + L].to(dev, copy=True).contiguous()
        Zr = Z[:, r0:r0 + L].to(dev, copy=True).contiguous() if want_z else None
        parts.append((r0, *_sweep.sweep_right_shard(Hr, Zr, logs[d], m, i, r0,
                                                     want_z=want_z, clo=clo)))
    for r0, Hr, Zr in parts:
        H[:, r0:r0 + L] = Hr.to(H.device)
        if want_z:
            Z[:, r0:r0 + L] = Zr.to(Z.device)
    return H, Z


@dataclasses.dataclass(frozen=True)
class ShardedSweep:
    """A ``sweep_fn`` for ``ops.pqr_real.pqr_real_core``: every sweep of the
    real core through ``chase_sweep_sharded`` over ``devices`` (one bulge a
    sweep, whatever ``AlgoConfig.nbulges``)."""

    devices: tuple

    def __call__(self, H, Z, m, i, v0, *, want_z, early=False, rhi=None, clo=None):
        return chase_sweep_sharded(H, Z, m, i, v0, devices=self.devices, want_z=want_z,
                                   early=early, rhi=rhi, clo=clo)


def pschur_real_sharded(A, devices: Optional[Sequence] = None, want_z: bool = True,
                        maxitfac: int = 30, cfg=None):
    """Real periodic Schur decomposition of one (p, n, n) cycle with the
    sweeps' applications sharded over ``devices`` (default: every card):
    the reduction (``phessenberg_core``) on the home device, then
    ``pqr_real_core`` (no AED, as the JAX package's ``pqr_real_core_ff``)
    with ``ShardedSweep``.

    A tensor is computed (reduced, and kernel A run) on its own device, the
    home device; an array goes to the mesh's first device.  n + 1 must be
    divisible by the mesh size.

    Returns (T, Z, w, ok): T and Z (p, n, n) tensors on the home device
    with ``Z[l].T @ A[l] @ Z[(l+1)%p] = T[l]`` (Z None without
    ``want_z``), w the complex eigenvalues (numpy), ok the convergence
    flag.
    """
    from ..config import default_config
    from ..ops.hessenberg import phessenberg_core
    from ..ops.pqr_real import pqr_real_core
    devices = make_mesh(devices=devices)
    if isinstance(A, torch.Tensor):
        At = A.to(torch.float64)
    else:
        At = torch.as_tensor(np.asarray(A, np.float64)).to(devices[0])
    _check_shards(At.shape[-1] + 1, len(devices))
    H, Q = phessenberg_core(At, want_q=want_z)
    T, Z, wr, wi, ok = pqr_real_core(H, Z=Q, want_z=want_z, maxitfac=maxitfac,
                                     cfg=cfg or default_config,
                                     sweep_fn=ShardedSweep(devices))
    return T, Z, wr + 1j * wi, bool(ok)
