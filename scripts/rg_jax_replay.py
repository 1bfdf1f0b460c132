#!/usr/bin/env python3
"""Step and replay the JAX package's f64 real generalized QZ core.

The JAX route ``pschur(A, 'R', S)`` on the rg cell's draw (p=8, n=256,
``default_rng(4242)``, alternating S) can end with a wrong factor 0.  This
script reduces the draw with the JAX signed reduction and steps the JAX
core one iteration at a time (``it_cap`` / ``resume_state``) up to the
state before iteration ``--at``.  It then runs that one iteration
``--reps`` times with the same compiled program from the same state, and
a sweep on the same window once through the PyTorch port's plain path
(``double_shift_sweep``).  For every iteration it prints
the iteration's own factor-0 backward error: max|Z0 H0 Z1' - Z0' H0' Z1''|
over the cycle the iteration started from (primes: its input), relative to
max|A|.  A correct iteration leaves it at rounding level.

With ``--full`` it runs the whole JAX f64 route on the draw instead (the
signed reduction, then the core to convergence with ``maxitfac=120``, as
``pschur_real_gen_pipeline`` does on the CPU) and prints niter and every
factor's backward error max|Z_l T_l Z_(l+1)' - A_l| / max|A| (Z_(l+1) and
Z_l swapped for an inverted factor).

Run from the repository root on the CPU (a few minutes; ``--full`` about
ten):
    python scripts/rg_jax_replay.py [--at 10] [--reps 12]
    python scripts/rg_jax_replay.py --full
Two instances at once load the host; ``taskset -c 0`` pins one to a core.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from periodicschurdecompositions_jl_tpu.ops.hessenberg import phessenberg_signed_core  # noqa: E402
from periodicschurdecompositions_jl_tpu.ops.pqz_real import pqz_real_gen_core  # noqa: E402
from periodicschurdecompositions_jl_torch.ops import pqz_real as port  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--at", type=int, default=10, help="the iteration to replay (1-based)")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--full", action="store_true", help="run the whole route instead")
    args = ap.parse_args()
    p, n = 8, 256
    S = tuple(l % 2 == 0 for l in range(p))
    A = np.random.default_rng(4242).standard_normal((p, n, n))
    scale = np.abs(A).max()

    def err0(H, Z, H_in, Z_in):
        """Factor 0 of (H, Z) against the cycle (H_in, Z_in) represents."""
        return float(np.abs(Z[0] @ H[0] @ Z[1].T - Z_in[0] @ H_in[0] @ Z_in[1].T).max()
                     / scale)

    t0 = time.perf_counter()
    H, Q = phessenberg_signed_core(jnp.asarray(A), S, want_q=True)
    Hn, Qn = np.asarray(H), np.asarray(Q)
    print(f"JAX signed reduction {time.perf_counter() - t0:.1f} s, factor-0 backward "
          f"error {float(np.abs(Qn[0] @ Hn[0] @ Qn[1].T - A[0]).max() / scale):.3e}",
          flush=True)
    if args.full:
        return full_route(A, S, H, Q, scale)

    def step(state, cap):
        out = pqz_real_gen_core(H, S, Z=Q, want_z=True, maxitfac=120,
                                it_cap=jnp.int32(cap), resume_state=state,
                                return_state=True)
        st = out[-2]
        return st, np.asarray(st[0][0]), np.asarray(st[0][1])

    bad = runs = 0
    state, Hb, Zb = None, Hn, Qn
    for k in range(1, args.at):
        state, Hk, Zk = step(state, k)
        e = err0(Hk, Zk, Hb, Zb)
        bad, runs = bad + (e > 1e-12), runs + 1
        print(f"JAX iteration {k}: ilast {int(state[0][6])}, the iteration's factor-0 "
              f"backward error {e:.3e}", flush=True)
        Hb, Zb = Hk, Zk
    sub = np.abs(np.diagonal(Hb[0], -1))
    print(f"state before iteration {args.at}: zero subdiagonals of H[0] at rows "
          f"{[int(r) + 1 for r in np.nonzero(sub == 0)[0]]}", flush=True)
    for r in range(args.reps):
        _, Hk, Zk = step(state, args.at)
        e = err0(Hk, Zk, Hb, Zb)
        bad, runs = bad + (e > 1e-12), runs + 1
        print(f"JAX replay {r + 1} of iteration {args.at}: factor-0 backward error "
              f"{e:.3e}", flush=True)
    print(f"JAX: {bad} of {runs} iterations above 1e-12", flush=True)

    # the port's plain path: a (non-exceptional) sweep on the same window
    # from the same state
    jlo = max([int(r) + 1 for r in np.nonzero(sub == 0)[0]], default=0)
    ilast = int(state[0][6])
    Hp, Zp = torch.tensor(Hb), torch.tensor(Zb)
    port.double_shift_sweep(Hp, Zp, S, jlo, ilast)
    print(f"port: a sweep on [{jlo}, {ilast}] from that state, factor-0 backward error "
          f"{err0(Hp.numpy(), Zp.numpy(), Hb, Zb):.3e}", flush=True)
    return 0


def full_route(A, S, H, Q, scale) -> int:
    """The core to convergence from the reduction (H, Q); prints niter and
    the backward error of every factor."""
    p = A.shape[0]
    t0 = time.perf_counter()
    out = pqz_real_gen_core(H, S, Z=Q, want_z=True, maxitfac=120, with_info=True)
    T, Z, ok, info = np.asarray(out[0]), np.asarray(out[1]), bool(out[-2]), out[-1]
    per = []
    for l in range(p):
        ln = (l + 1) % p
        Ax = Z[l] @ T[l] @ Z[ln].T if S[l] else Z[ln] @ T[l] @ Z[l].T
        per.append(float(np.abs(Ax - A[l]).max() / scale))
    orth = max(float(np.abs(z.T @ z - np.eye(z.shape[0])).max()) for z in Z)
    print(f"JAX full route: core {time.perf_counter() - t0:.1f} s, converged {ok}, niter "
          f"{int(info['niter'])}, backward error per factor "
          f"{', '.join(f'{x:.3e}' for x in per)}, orthonormality {orth:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
