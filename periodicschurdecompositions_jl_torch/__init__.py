"""Periodic Schur decompositions in PyTorch, with CUDA kernels for Hopper.

Port of the JAX package ``periodicschurdecompositions_jl_tpu`` (the
reference implementation).  Computes in float64 / complex128.  A torch
tensor is computed on its own device; an array or a sequence of matrices
goes to ``device`` (default ``"cuda"``; without a card pass
``device="cpu"``).  On a CUDA device the periodic Hessenberg reduction
of direct factors (real and complex), the real iteration's per-iteration
glue (kernel G), the real Francis sweep (one bulge, and NB bulges with
``AlgoConfig(nbulges>1)``), the 2x2 deflation, the complex QZ sweep and
its shift, and the real generalized chase and its rotation ladders run as
hand-written CUDA kernels (``csrc/``, built with nvcc on first use), on
the CPU as their plain torch versions.  Sets no global torch state.

The three iterations of ``pschur`` (real, real with a signature, complex)
run with aggressive early deflation and the host-tail finish
(``AlgoConfig.aed``, ``host_tail``: on by default, AED from n = 192), their
window analyses on the host with the repo's native C++ window Schurs
(``native.py``, built with g++ on first use).

Ported so far: ``pschur`` for real and complex cycles with or without a
signature, ``gpschur`` for real and complex pairs, ``phessenberg``,
``ordschur``, ``eigvecs``, ``check_psd`` and ``FacChecker``;
``partial_pschur`` (periodic Krylov-Schur: on a tensor on the card the
operator applications and the Gram-Schmidt run on the card, the restart
logic on the host; ``models.vectors.eigvecs_partial`` takes its result);
``save_decomposition`` / ``load_decomposition`` (files interchangeable
with the JAX package's) and ``balance_pcycle``.  ``want_t=False`` keeps
every update inside the iteration's active window (the kernels take the
bound): the eigenvalues and Z are those of the run with T, and T is valid
on its diagonal blocks only.

Several devices from one process (``parallel``): ``make_mesh`` (a tuple
of devices), ``batched_pschur_real`` / ``batched_pschur_complex`` (problems
round-robin over the devices, worker threads on their own streams) and
``ensemble_pschur_real_pipelined`` (one card, problems overlapped);
``ring_cycle_products`` / ``ring_product_apply`` (the factors over the
devices); ``chase_sweep_sharded``, ``ShardedSweep`` and
``pschur_real_sharded`` (the sweep's B0 and B on column and row shards,
kernels ``psd_sweep_left_shard`` / ``psd_sweep_right_shard``);
``sharded_dense_ops`` and ``ShardedCycleOps`` (row-sharded Krylov
operators).  ``pschur_mp`` (mpmath, host) computes at any precision.
"""
from .config import AlgoConfig, default_config, setverbosity, verbosity
from .diagnostics import FacChecker, check_psd
from .models.drivers import gpschur, phessenberg, pschur
from .models.krylov import ArnoldiHistory, partial_pschur
from .models.ordschur import ordschur
from .models.vectors import eigvecs
from .ops.pqz_mp import MpGeneralizedPeriodicSchur, pschur_mp
from .parallel.krylov_ops import ShardedCycleOps, sharded_dense_ops
from .parallel.mesh import (batched_pschur_complex, batched_pschur_real,
                            ensemble_pschur_real_pipelined, make_mesh)
from .parallel.ring import ring_cycle_products, ring_product_apply
from .parallel.sweep_sharded import ShardedSweep, chase_sweep_sharded, pschur_real_sharded
from .types import (AbstractPeriodicSchur, ConvergenceFailure, GeneralizedPeriodicSchur,
                    IllConditionedException, PartialPeriodicSchur, PeriodicSchur,
                    PKSFailure, PSDNotImplemented)
from .utils.balance import balance_pcycle
from .utils.io import load_decomposition, save_decomposition

__all__ = [
    "AlgoConfig", "default_config", "setverbosity", "verbosity", "check_psd",
    "FacChecker", "gpschur", "phessenberg", "pschur", "ordschur", "eigvecs",
    "partial_pschur", "ArnoldiHistory", "save_decomposition",
    "load_decomposition", "balance_pcycle", "AbstractPeriodicSchur",
    "ConvergenceFailure", "GeneralizedPeriodicSchur", "IllConditionedException",
    "PartialPeriodicSchur", "PeriodicSchur", "PKSFailure", "PSDNotImplemented",
    "pschur_mp", "MpGeneralizedPeriodicSchur", "make_mesh", "batched_pschur_real",
    "batched_pschur_complex", "ensemble_pschur_real_pipelined", "ring_cycle_products",
    "ring_product_apply", "sharded_dense_ops", "ShardedCycleOps", "ShardedSweep",
    "chase_sweep_sharded", "pschur_real_sharded",
]
