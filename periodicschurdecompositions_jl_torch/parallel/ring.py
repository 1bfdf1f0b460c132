"""Cycle ring: the factor axis over a list of devices (the JAX package's
``parallel/ring.py``).

The p factors of a periodic problem form a ring: applying the cyclic
product to vectors walks factor 0, 1, ..., p-1.  With the factors split
into D contiguous blocks over the devices of a mesh (device d holds factors
[dK, (d+1)K), K = p/D) a vector block walks the ring card after card: each
hop applies a card's K local factors and moves the block to the next card.
The JAX package rotates the blocks with ``lax.ppermute`` inside a
``shard_map``; here one process moves them by peer copies (``.to``, which
orders the copy after the source's stream and before the destination's).
The products are ``torch.matmul``, as they are ``jnp`` products there (no
kernel of the JAX package is on this path).

Shards and blocks are copies even where two entries of the mesh name one
device, so a mesh of D entries on one card (or on the CPU) takes the same
path as D cards.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .mesh import make_mesh


def _shards(A, devices):
    """Factor blocks [dK, (d+1)K) of the (p, n, n) stack, copied to device d."""
    D = len(devices)
    p = A.shape[0]
    if p % D != 0:
        raise ValueError(f"the cycle length p={p} must be divisible by the mesh size {D}")
    K = p // D
    return [A[d * K:(d + 1) * K].to(dev, copy=True) for d, dev in enumerate(devices)]


def _apply_local(Ash, v):
    for k in range(Ash.shape[0]):
        v = Ash[k] @ v
    return v


def ring_cycle_products(A: torch.Tensor, V: torch.Tensor, mesh: Sequence):
    """All cyclic rotations of the product, one per vector block.

    Args:
      A: (p, n, n) factor stack; p must be divisible by the mesh size D;
         device d gets factors [dK, (d+1)K), K = p/D.
      V: (D, n, b) vector blocks; block d starts on device d.
      mesh: the devices (``make_mesh``); one may appear more than once.

    Returns:
      (D, n, b) on the mesh's first device: block d multiplied, in ring
      order, by all p factors starting from factor dK (the rotation
      ``A[dK-1] ... A[0] A[p-1] ... A[dK]``), as the JAX function returns
      it (there sharded, block d back on device d).
    """
    devices = make_mesh(devices=mesh)
    D = len(devices)
    if V.shape[0] != D:
        raise ValueError(f"V has {V.shape[0]} blocks for a mesh of {D}")
    shards = _shards(A, devices)
    blocks = [V[d].to(devices[d], copy=True) for d in range(D)]
    for _ in range(D):
        # every card applies its factors to the block it holds (the cards
        # run side by side), then each block moves to the next card
        blocks = [_apply_local(shards[d], blocks[d]) for d in range(D)]
        blocks = [blocks[(d - 1) % D].to(devices[d], copy=True) for d in range(D)]
    home = devices[0]
    return torch.stack([b.to(home, copy=True) for b in blocks])


def ring_product_apply(A: torch.Tensor, v: torch.Tensor, mesh: Sequence):
    """The full left product ``A[p-1] @ ... @ A[0]`` applied to v, (n,) or
    (n, b): the vector walks the ring from the first card to the last, one
    card computing per hop.  Returns the result on the mesh's first
    device."""
    devices = make_mesh(devices=mesh)
    shards = _shards(A, devices)
    x = v if v.ndim == 2 else v[:, None]
    for d, dev in enumerate(devices):
        x = _apply_local(shards[d], x.to(dev, copy=True))
    x = x.to(devices[0], copy=True)
    return x if v.ndim == 2 else x[:, 0]
