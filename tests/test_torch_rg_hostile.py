"""The hostile real generalized draws of benchmarks/probe_rg_hostile.py on
the port's CPU route.

``chip_smoke.hostile_rg_cases`` (the card's copy of the probe's draws: the
card machine has no JAX) must build the probe's 33 draws (14 in its quick
subset).  One draw of each class, at one small shape (p=6, n=16), goes through
``pschur(A, 'R', S)`` on a CPU tensor and is held against the JAX
package's native C++ core (``native.pqz_real_gen_niter_cpu``, the probe's
oracle) on the same reduction: convergence within 120 n iterations, the
backward error honouring S <= 1e-12, each eigenvalue within 1e-10 of the
native core's relative to its modulus; both iteration counts in the
message.  No JAX core is compiled.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops import hessenberg, pqz_real
from periodicschurdecompositions_jl_tpu import native as jnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (cx_backerr, hostile_exp_split, hostile_graded,  # noqa: E402
                        hostile_near_singular, hostile_rg_cases)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_rg_hostile", os.path.join(ROOT, "benchmarks", "probe_rg_hostile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_draws_are_the_probes():
    probe = _probe()
    for quick, count in ((True, 14), (False, 33)):
        cases = hostile_rg_cases(quick)
        assert len(cases) == count
        for tag, A, S in cases:
            kind, rest = tag.split(" p=", 1)
            p = int(rest.split()[0])
            n = int(rest.split("n=")[1].split()[0])
            seed = int(tag.rsplit("seed=", 1)[1])
            if kind == "exp-split":
                fac = float(tag.split("fac=")[1].split()[0])
                ref = probe.exp_split(p, n, fac, seed)
            elif kind == "near-sing-inv":
                floor = float(tag.split("floor=")[1].split()[0])
                ref = probe.near_singular_inverted(p, n, floor, seed)
            else:
                ref = probe.graded_band(p, n, seed)
            assert np.array_equal(A, ref[0]) and S == ref[1], tag
    for mine, theirs, args in ((hostile_exp_split, probe.exp_split, (6, 16, 2.0, 0)),
                               (hostile_near_singular, probe.near_singular_inverted,
                                (6, 16, 1e-10, 0)),
                               (hostile_graded, probe.graded_band, (6, 16, 0))):
        A, S = mine(*args)
        assert np.array_equal(A, theirs(*args)[0]) and S == theirs(*args)[1]


def _match(w, ref):
    """Each eigenvalue of ``ref`` against its nearest unused one of ``w``,
    relative to its modulus."""
    rest = list(w)
    worst = 0.0
    for r in sorted(ref, key=abs, reverse=True):
        j = min(range(len(rest)), key=lambda q: abs(rest[q] - r))
        worst = max(worst, abs(rest.pop(j) - r) / abs(r))
    return worst


@pytest.mark.parametrize("kind", ["exp-split", "near-sing-inv", "graded"])
def test_one_draw_of_each_class_on_the_cpu(kind):
    if kind == "exp-split":
        A, S = hostile_exp_split(6, 16, 2.0, 0)
    elif kind == "near-sing-inv":
        A, S = hostile_near_singular(6, 16, 1e-10, 0)
    else:
        A, S = hostile_graded(6, 16, 0)
    tag = f"{kind} p=6 n=16 seed=0"
    n = A.shape[-1]
    At = torch.tensor(A)
    P = pt.pschur(At, "R", S)
    niter = pqz_real.last_info["niter"]
    H, _ = hessenberg.phessenberg_signed_core(At, S, want_q=False)
    rc, nn, out = jnative.pqz_real_gen_niter_cpu(H.numpy(), S)
    msg = f"{tag}: port niter {niter}, native core rc {rc} niter {nn}"
    assert rc == 0 and niter <= 120 * n, msg
    assert cx_backerr(A, P.Ts.numpy(), P.Zs.numpy(), S) <= 1e-12, msg
    alr, ali, beta, scale = out[2:]
    ref = (alr + 1j * ali) / beta * np.exp2(scale.astype(float))
    assert _match(P.values.numpy(), ref) <= 1e-10, msg
