"""The cycle ring (``parallel/ring.py``) and the row-sharded Krylov
operators (``parallel/krylov_ops.py``) against the JAX package's, on CPU
tensors: the JAX functions on the 8-device virtual CPU mesh
(tests/conftest.py), the port's over a mesh of CPU entries (shards by
explicit copies, the path of D cards).

Gates: the ring within 1e-12 relative to the largest entry; the sharded
Krylov Ritz values (``ShardedCycleOps`` and ``sharded_dense_ops`` through
``partial_pschur``) within 1e-10 relative of the JAX ``sharded_dense_ops``
run with the same draw and start vector, ``nconverged`` equal, the
partial decomposition's residual below 1e-7 (tests/test_parallel_krylov.py).
"""
import jax
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt

CPU = torch.device("cpu")



@pytest.fixture(autouse=True)
def _cpu_mesh():
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")


def _jmesh(name):
    from periodicschurdecompositions_jl_tpu.parallel.mesh import make_mesh
    return make_mesh(8, names=(name,))


def test_ring_cycle_products_match_jax():
    from periodicschurdecompositions_jl_tpu.parallel.ring import ring_cycle_products
    import jax.numpy as jnp
    rng = np.random.default_rng(31)
    p, n, b, D = 16, 12, 3, 8
    A = rng.standard_normal((p, n, n)) / np.sqrt(n)
    V = rng.standard_normal((D, n, b))
    ref = np.asarray(ring_cycle_products(jnp.asarray(A), jnp.asarray(V), _jmesh("cycle")))
    out = pt.ring_cycle_products(torch.tensor(A), torch.tensor(V), [CPU] * D)
    assert out.shape == (D, n, b) and out.device == CPU
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(ValueError, match="divisible"):
        pt.ring_cycle_products(torch.tensor(A[:12]), torch.tensor(V), [CPU] * D)


@pytest.mark.parametrize("vec", [True, False])
def test_ring_product_apply_matches_jax(vec):
    from periodicschurdecompositions_jl_tpu.parallel.ring import ring_product_apply
    import jax.numpy as jnp
    rng = np.random.default_rng(32)
    p, n = 8, 12
    A = rng.standard_normal((p, n, n)) / np.sqrt(n)
    v = rng.standard_normal(n) if vec else rng.standard_normal((n, 2))
    ref = np.asarray(ring_product_apply(jnp.asarray(A), jnp.asarray(v), _jmesh("cycle")))
    out = pt.ring_product_apply(torch.tensor(A), torch.tensor(v), [CPU] * 4)
    assert out.shape == v.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _krylov_draw(rng, p, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = []
    for _ in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.05)
        np.fill_diagonal(T, 1.15 ** np.arange(n))
        A.append(q @ T @ q.T)
    return np.stack(A)


@pytest.fixture(scope="module")
def krylov_ref():
    from periodicschurdecompositions_jl_tpu.models.krylov import partial_pschur
    from periodicschurdecompositions_jl_tpu.parallel.krylov_ops import sharded_dense_ops
    A = _krylov_draw(np.random.default_rng(1234), 2, 48)
    ops, n, dt = sharded_dense_ops(A, _jmesh("rows"))
    ps, h = partial_pschur(ops, 4, "LM", n=n, dtype=dt, seed=5)
    return A, np.asarray(ps.values), h


@pytest.mark.parametrize("kind", ["cycle_ops", "dense_ops"])
def test_sharded_krylov_matches_jax(krylov_ref, kind):
    A, wj, hj = krylov_ref
    p, n = A.shape[0], A.shape[1]
    if kind == "cycle_ops":
        ops = pt.ShardedCycleOps(torch.tensor(A), [CPU] * 4)
        ps, h = pt.partial_pschur(ops, 4, "LM", seed=5)
        assert h.host_reads == 2 * h.nprods  # the coefficients and the column, once each
    else:
        ops, nn, dt = pt.sharded_dense_ops(torch.tensor(A), [CPU] * 4)
        ps, h = pt.partial_pschur(ops, 4, "LM", n=nn, dtype=dt, device="cpu", seed=5)
    assert h.nconverged == hj.nconverged >= 4
    a, b = np.sort_complex(ps.values.numpy()), np.sort_complex(wj)
    assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    V, T = ps.Vs.numpy(), ps.Ts.numpy()
    for l in range(p):
        assert np.abs(A[l] @ V[l] - V[(l + 1) % p] @ T[l]).max() < 1e-7


def test_sharded_cycle_ops_need_n_divisible():
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        pt.ShardedCycleOps(torch.zeros((2, 10, 10), dtype=torch.float64), [CPU] * 4)
