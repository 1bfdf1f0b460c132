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
``ordschur``, ``eigvecs`` and ``check_psd``.  ``want_t=False`` keeps every
update inside the iteration's active window (the kernels take the bound):
the eigenvalues and Z are those of the run with T, and T is valid on its
diagonal blocks only.
"""
from .config import AlgoConfig, default_config, setverbosity, verbosity
from .diagnostics import check_psd
from .models.drivers import gpschur, phessenberg, pschur
from .models.ordschur import ordschur
from .models.vectors import eigvecs
from .types import (ConvergenceFailure, GeneralizedPeriodicSchur,
                    IllConditionedException, PeriodicSchur, PSDNotImplemented)

__all__ = [
    "AlgoConfig", "default_config", "setverbosity", "verbosity", "check_psd",
    "gpschur", "phessenberg", "pschur", "ordschur", "eigvecs", "ConvergenceFailure",
    "GeneralizedPeriodicSchur", "IllConditionedException", "PeriodicSchur",
    "PSDNotImplemented",
]
