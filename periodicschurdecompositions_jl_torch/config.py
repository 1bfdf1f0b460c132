"""Algorithm configuration and verbosity (PyTorch port of ``config.py``).

Only the switches the real periodic QR core reads are carried; the
semantics are those of the JAX package's ``AlgoConfig``:

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
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Static algorithm switches for the real periodic QR core."""

    slicot_shifts: bool = False
    slicot_convg: bool = False
    at_pwr16: int = 4
    extra_rq: bool = False
    allow_early_qr: bool = False
    nbulges: int = 1
    bulge_gap: int = 3

    def ulp_x(self, ulp: float) -> float:
        """Tightened Ahues-Tisseur relative threshold ``eps^(1+at_pwr16/16)``."""
        return ulp ** (1.0 + self.at_pwr16 / 16.0)


default_config = AlgoConfig()

# Verbosity: host-side, keyed channels (the JAX package's keys that the
# ported modules read).
_VERBOSITY = {"main": 0}


def setverbosity(level: int, key: str = "main") -> None:
    """Set diagnostic verbosity for a subsystem (0 silent, 1 progress)."""
    if key not in _VERBOSITY:
        raise ValueError(f"unknown verbosity key {key!r}; known: {sorted(_VERBOSITY)}")
    _VERBOSITY[key] = int(level)


def verbosity(key: str = "main") -> int:
    return _VERBOSITY[key]
