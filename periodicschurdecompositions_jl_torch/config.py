"""Algorithm configuration and verbosity (PyTorch port of ``config.py``).

Only the switches the ported modules read are carried; the semantics are
those of the JAX package's ``AlgoConfig``:

* ``slicot_shifts``: SLICOT's shift computation instead of dlahqr's.
* ``slicot_convg``: SLICOT's (laxer) deflation criterion instead of the
  Ahues-Tisseur test.
* ``at_pwr16``: the Ahues-Tisseur threshold is ``eps^(1 + at_pwr16/16)``.
* ``extra_rq``: the extra final RQ stage of the subdiagonal repair chain
  (off by default; MB03WD force-zeroes the leftover instead).
* ``allow_early_qr``: start the double-shift sweep below the window top
  where two consecutive subdiagonals are small (dlahqr's early start; off
  by default).  Ignored when ``nbulges > 1``: the bulges start at the
  window top.
* ``nbulges``: double-shift bulges chased per sweep, each ``bulge_gap``
  columns behind the one before (``bulge_gap >= 3``).  Their shifts are
  the eigenvalues of the trailing ``2 nbulges`` window of the cycle
  product (``ops/smallschur.py``).  1, the default, is the reference's
  single-bulge Francis sweep.
* ``iterative_2x2``: ``ordschur`` re-solves a 2x2 block's eigenvalues
  with the iterative MB03BB-style periodic QZ instead of the one-shot
  scaled product (falls back to it when the iteration does not converge).
* ``aed``, ``aed_window``, ``aed_interval``, ``aed_min_n``,
  ``aed_max_moves``: aggressive early deflation of the three iterations
  (``ops/aed.py``; the real one driven by
  ``ops/pqr_real.py::pqr_real_core_aed``, the real generalized and complex
  ones by ``ops/aed.py::drive_signed``).  Every ``aed_interval``
  iterations (0: ``max(24, n // 4)`` on the real iteration, ``max(24, n //
  6)`` on the others, as the JAX drivers; doubled after two misses) the
  trailing ``aed_window`` window (0: ``min(48, max(16, n // 10))``) is
  brought to periodic Schur form on the host and its converged eigenvalues
  are deflated from the spike.  On at ``n >= aed_min_n``, or at any n with
  an explicit ``aed_window``.  ``aed_max_moves`` caps the failed-block
  moves of one analysis (-1: unlimited).
* ``eta_orth``: the iterated Gram-Schmidt re-orthogonalization threshold
  of the periodic Arnoldi process in ``partial_pschur`` (reference
  src/krylov.jl:150).
* ``host_tail``: once the active window has shrunk to ``host_tail`` rows
  or fewer, one host window Schur finishes it (0: ``min(64, n // 8)``;
  -1: off).  The window Schurs are the repo's native C++ ones
  (``native.py``, built with g++ on first use).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Static algorithm switches of the iteration cores and reordering."""

    slicot_shifts: bool = False
    slicot_convg: bool = False
    at_pwr16: int = 4
    extra_rq: bool = False
    allow_early_qr: bool = False
    nbulges: int = 1
    bulge_gap: int = 3
    iterative_2x2: bool = False
    aed: bool = True
    aed_window: int = 0
    aed_interval: int = 0
    aed_min_n: int = 192
    host_tail: int = 0
    aed_max_moves: int = 4
    eta_orth: float = 1.0 / math.sqrt(2.0)

    def ulp_x(self, ulp: float) -> float:
        """Tightened Ahues-Tisseur relative threshold ``eps^(1+at_pwr16/16)``."""
        return ulp ** (1.0 + self.at_pwr16 / 16.0)


default_config = AlgoConfig()

# Verbosity: host-side, keyed channels (the JAX package's keys that the
# ported modules read).
_VERBOSITY = {"main": 0, "krylov": 0, "sylswap": 0, "rordschur": 0, "r2x2": 0}


def setverbosity(level: int, key: str = "main") -> None:
    """Set diagnostic verbosity for a subsystem (0 silent, 1 progress)."""
    if key not in _VERBOSITY:
        raise ValueError(f"unknown verbosity key {key!r}; known: {sorted(_VERBOSITY)}")
    _VERBOSITY[key] = int(level)


def verbosity(key: str = "main") -> int:
    return _VERBOSITY[key]
