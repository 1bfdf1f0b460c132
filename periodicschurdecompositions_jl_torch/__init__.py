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
"""
from .config import AlgoConfig, default_config, setverbosity, verbosity
from .diagnostics import FacChecker, check_psd
from .models.drivers import gpschur, phessenberg, pschur
from .models.krylov import ArnoldiHistory, partial_pschur
from .models.ordschur import ordschur
from .models.vectors import eigvecs
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
]
