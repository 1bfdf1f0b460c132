"""Several problems at once: batches over a list of devices, and a pipelined
ensemble on one card (the JAX package's ``parallel/mesh.py``).

A "mesh" is an ordered tuple of ``torch.device``s (``make_mesh``), driven
by one Python process: no process group.  The JAX package vmaps its f64
cores over a batch and shards the batch over a ``Mesh``; here every problem
runs through the port's own reduction and core on the device the mesh
gives it, problems going round-robin over the devices and, within a
device, over worker threads, each on its own CUDA stream (PyTorch's current
stream is per thread).  The kernels launch on their tensor's card, so
problems on different cards run side by side; on one card the streams let
one problem's device work overlap another's host control.

A device may appear more than once in a mesh: each entry is one more
worker of that device.  Results are stacked on the mesh's first device.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
from typing import Optional, Sequence

import numpy as np
import torch


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> tuple:
    """The first ``n_devices`` of ``devices`` (default: every visible CUDA
    card) as a tuple of ``torch.device``; raises ValueError when fewer
    devices exist than are asked for, or none."""
    if devices is None:
        devs = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("no device for the mesh (no CUDA card visible; pass devices=)")
    return tuple(devs)


def _home(A, mesh):
    """The devices the problems go to: the mesh, else the batch's own
    device (a tensor) or the card (an array)."""
    if mesh is not None:
        return make_mesh(devices=mesh)
    if isinstance(A, torch.Tensor):
        return (A.device,)
    from ..models.drivers import _target
    return (_target(None),)


def run_problems(fn, problems, devices, workers: int = 1):
    """``fn(problem, device)`` for each problem, problem b on
    ``devices[b % len(devices)]``, with ``workers`` threads per entry of
    ``devices``, each thread on a CUDA stream of its own (the current
    stream while it runs ``fn``).  Returns the results in input order; an
    exception in any thread reaches the caller.  One device and one worker:
    the calls run in this thread, on its current stream."""
    problems = list(problems)
    nd = len(devices)
    if nd * max(1, workers) == 1 or not problems:
        return [fn(a, devices[0]) for a in problems]
    # the threads' streams must see what the caller's streams made so far
    srcs = {t.device for t in problems if isinstance(t, torch.Tensor)}
    for d in srcs | set(devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()

    def lane(q):
        # lane q: every (nd * workers)-th problem from q, on devices[q % nd]
        dev = devices[q % nd]
        out = []
        ctx = (torch.cuda.stream(torch.cuda.Stream(dev)) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            for b in range(q, len(problems), nlanes):
                out.append((b, fn(problems[b], dev)))
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return out

    nlanes = min(nd * max(1, workers), len(problems))
    res = [None] * len(problems)
    with cf.ThreadPoolExecutor(max_workers=nlanes) as ex:
        for fut in [ex.submit(lane, q) for q in range(nlanes)]:
            for b, r in fut.result():
                res[b] = r
    return res


def _copy_to(t, dev):
    """A copy of ``t`` on ``dev``, never ``t`` itself."""
    return t.to(dev, copy=True)


def _stack_on(results, dev):
    """Stack the per-problem tuples field by field on ``dev`` (host arrays
    and scalars become tensors; None stays None)."""
    out = []
    for field in zip(*results):
        if field[0] is None:
            out.append(None)
            continue
        ts = [f if isinstance(f, torch.Tensor) else torch.as_tensor(np.asarray(f))
              for f in field]
        out.append(torch.stack([_copy_to(t, dev) for t in ts]))
    if dev.type == "cuda":
        # the per-problem tensors go back to their threads' streams' pools
        torch.cuda.current_stream(dev).synchronize()
    return tuple(out)


def batched_pschur_real(A_batch, mesh: Optional[Sequence] = None, want_z: bool = True,
                        maxitfac: int = 30, workers: int = 2):
    """Batched real periodic Schur: A_batch (B, p, n, n) -> stacked results.

    Each problem runs the reduction (``phessenberg_core``) and the real QR
    core without AED (``pqr_real_core``), as the JAX package's vmapped lane
    does, on ``mesh[b % len(mesh)]`` with ``workers`` threads per device.
    Without a mesh every problem runs on the batch's device (a tensor) or
    on the card (an array); ``mesh=["cpu"]`` runs an array on the CPU.

    Returns (T, Z, wr, wi, ok) with a leading batch axis, on the first
    device (Z None without ``want_z``).
    """
    from ..ops.hessenberg import phessenberg_core
    from ..ops.pqr_real import pqr_real_core
    devs = _home(A_batch, mesh)
    src = A_batch if isinstance(A_batch, torch.Tensor) else torch.as_tensor(
        np.asarray(A_batch, np.float64))

    def one(A, dev):
        A = _copy_to(A, dev).to(torch.float64)
        H, Q = phessenberg_core(A, want_q=want_z)
        return pqr_real_core(H, Z=Q, want_z=want_z, maxitfac=maxitfac)

    res = run_problems(one, list(src), devs, workers)
    return _stack_on(res, devs[0])


def batched_pschur_complex(A_batch, S, mesh: Optional[Sequence] = None, want_z: bool = True,
                           maxitfac: int = 30, workers: int = 2):
    """Batched complex periodic QZ over a problem batch (see
    ``batched_pschur_real``): the reduction (``phessenberg_core``, or
    ``phessenberg_signed_core`` when S is not all True) and
    ``pqz_complex_core`` without AED for each problem.

    Returns (T, Z, alpha, beta, alphascale, ok) with a leading batch axis,
    on the first device.
    """
    from ..ops.hessenberg import phessenberg_core, phessenberg_signed_core
    from ..ops.pqz_complex import pqz_complex_core
    S = tuple(bool(x) for x in S)
    devs = _home(A_batch, mesh)
    src = A_batch if isinstance(A_batch, torch.Tensor) else torch.as_tensor(
        np.asarray(A_batch))

    def one(A, dev):
        A = _copy_to(A, dev).to(torch.complex128)
        if all(S):
            H, Q = phessenberg_core(A, want_q=want_z)
        else:
            H, Q = phessenberg_signed_core(A, S, want_q=want_z)
        return pqz_complex_core(H, S, Z=Q, want_z=want_z, maxitfac=maxitfac)

    res = run_problems(one, list(src), devs, workers)
    return _stack_on(res, devs[0])


def ensemble_pschur_real_pipelined(As, want_z: bool = True, maxitfac: int = 40,
                                   workers: int = 2, device=None):
    """Host-pipelined ensemble on ONE card: problems/min above the
    sequential loop.

    Each problem runs the port's real route with its defaults (the
    reduction and ``pqr_real_core_aed``: AED from ``aed_min_n``, the host
    tail), as ``pschur`` does, but returns the convergence flag instead of
    raising.  A problem's wall is device work plus host work (iteration
    control, reads, the host-tail finish); ``workers`` threads, each on its
    own stream, keep the card busy while another problem is in its host
    phase.  ``workers=1``: the plain sequential loop, on the caller's
    stream.

    Args:
      As: sequence of (p, n, n) real cycles (arrays or tensors).
      device: the card (default ``"cuda"``; ``"cpu"`` for the plain
        versions).

    Returns a list of (T, Z, wr, wi, ok) numpy tuples, in input order (Z
    None without ``want_z``).
    """
    from ..models.drivers import _target
    from ..ops.pqr_real import reduce_and_iterate
    dev = _target(device)

    def one(A, dev):
        At = torch.as_tensor(A, dtype=torch.float64).to(dev, copy=True)
        T, Z, wr, wi, ok, _ = reduce_and_iterate(At, want_z=want_z, maxitfac=maxitfac)
        return (T.cpu().numpy(), None if Z is None else Z.cpu().numpy(), wr, wi, bool(ok))

    return run_problems(one, As, (dev,), workers)
