"""The PyTorch port imports without JAX, and its kernel loader never falls back."""
import concurrent.futures
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import (_cuda, deflate, glue, hessenberg, rgopen,
                                                     sweep, sweep_cx, sweep_rg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
sys.modules['jax'] = None  # any 'import jax' now raises ImportError
import periodicschurdecompositions_jl_torch as pt
import periodicschurdecompositions_jl_torch.native
import periodicschurdecompositions_jl_torch.models.krylov
import periodicschurdecompositions_jl_torch.models.ordschur
import periodicschurdecompositions_jl_torch.models.vectors
import periodicschurdecompositions_jl_torch.ops._cuda
import periodicschurdecompositions_jl_torch.ops.aed
import periodicschurdecompositions_jl_torch.ops.deflate
import periodicschurdecompositions_jl_torch.ops.glue
import periodicschurdecompositions_jl_torch.ops.hessenberg
import periodicschurdecompositions_jl_torch.ops.pqr_real
import periodicschurdecompositions_jl_torch.ops.pqz_complex
import periodicschurdecompositions_jl_torch.ops.pqz_deflate
import periodicschurdecompositions_jl_torch.ops.pqz_mp
import periodicschurdecompositions_jl_torch.ops.pqz_real
import periodicschurdecompositions_jl_torch.ops.reorder_np
import periodicschurdecompositions_jl_torch.ops.rgopen
import periodicschurdecompositions_jl_torch.ops.smallschur
import periodicschurdecompositions_jl_torch.ops.sweep
import periodicschurdecompositions_jl_torch.ops.sweep_cx
import periodicschurdecompositions_jl_torch.ops.sweep_rg
import periodicschurdecompositions_jl_torch.parallel.krylov_ops
import periodicschurdecompositions_jl_torch.parallel.mesh
import periodicschurdecompositions_jl_torch.parallel.ring
import periodicschurdecompositions_jl_torch.parallel.sweep_sharded
import periodicschurdecompositions_jl_torch.utils.balance
import periodicschurdecompositions_jl_torch.utils.circshift
import periodicschurdecompositions_jl_torch.utils.interop
import periodicschurdecompositions_jl_torch.utils.io
import periodicschurdecompositions_jl_torch.utils.safeprod
assert not any(m.startswith('periodicschurdecompositions_jl_tpu') for m in sys.modules)
assert sys.modules['jax'] is None
from periodicschurdecompositions_jl_torch.ops.sweep import chase_sweep_mb
print(pt.pschur.__name__, pt.check_psd.__name__, chase_sweep_mb.__name__,
      pt.ordschur.__name__, pt.eigvecs.__name__, pt.partial_pschur.__name__,
      pt.load_decomposition.__name__, pt.balance_pcycle.__name__,
      pt.ensemble_pschur_real_pipelined.__name__, pt.pschur_real_sharded.__name__,
      pt.ring_cycle_products.__name__, pt.ShardedCycleOps.__name__, pt.pschur_mp.__name__)
"""

_NO_MPMATH = """
import sys
sys.modules['mpmath'] = None  # any 'import mpmath' now raises ImportError
sys.modules['jax'] = None
import numpy as np
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops import pqz_mp
assert not pqz_mp.HAVE_MPMATH
try:
    pt.pschur_mp(np.eye(3)[None])
except RuntimeError as e:
    print('RuntimeError:', e)
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert ("pschur check_psd chase_sweep_mb ordschur eigvecs partial_pschur "
            "load_decomposition balance_pcycle ensemble_pschur_real_pipelined "
            "pschur_real_sharded ring_cycle_products ShardedCycleOps pschur_mp") in res.stdout


def test_port_imports_without_mpmath_and_pschur_mp_raises():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _NO_MPMATH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "RuntimeError: mpmath is required" in res.stdout


def test_cuda_loader_raises_without_nvcc(monkeypatch, tmp_path):
    # hide every nvcc the loader could find; it must raise, not stand in
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.load()
    assert _cuda._lib is None


def test_cuda_loader_builds_once_under_threads(monkeypatch, tmp_path):
    # many threads on a cold start: one build, one library for all
    builds = []

    def fake_build(nvcc, srcs, so):
        builds.append(so)
        time.sleep(0.01)
        so.write_bytes(b"")

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_BUILD", tmp_path)
    monkeypatch.setattr(_cuda, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda, "_build", fake_build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_cuda, "_declare", lambda lib: lib)
    start = threading.Barrier(16)

    def call():
        start.wait(timeout=30)
        return _cuda.load()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            libs = list(ex.map(lambda _: call(), range(16), timeout=60))
    finally:
        sys.setswitchinterval(old)
    assert len(builds) == 1 and all(lib is libs[0] for lib in libs)


@pytest.mark.parametrize("fn", ["sweep", "sweep_mb", "sweep_generate_mb", "deflate",
                                "qz_sweep", "qz_shift", "qz_sweep_generate", "rg_chase",
                                "rg_ladder", "hess", "glue", "sweep_generate",
                                "sweep_left_shard", "sweep_right_shard"])
def test_wrappers_refuse_other_devices(fn):
    H = torch.zeros((2, 5, 5), dtype=torch.float64, device="meta")
    Hc = torch.zeros((2, 5, 5), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "sweep":
            sweep.chase_sweep(H, None, 0, 3, [1.0, 0.0, 0.0], want_z=False)
        elif fn == "sweep_mb":
            sweep.chase_sweep_mb(H, None, 0, 3, [1.0, 0.0, 0.0], [(0.0, 0.0, 0.0)] * 2, 2,
                                 nb=2, gap=3, want_z=False)
        elif fn == "sweep_generate_mb":
            sweep.sweep_generate_mb(H, 0, 3, [1.0, 0.0, 0.0], [(0.0, 0.0, 0.0)] * 2, 2,
                                    nb=2, gap=3)
        elif fn == "deflate":
            deflate.deflate2x2(H, None, 2, -1, -1, 1.0, 0.0, False, False,
                               1e-300, want_z=False)
        elif fn == "qz_sweep":
            sweep_cx.qz_sweep(Hc, None, 0, 3, torch.zeros(2, dtype=torch.complex128,
                                                          device="meta"),
                              (True, False), want_z=False)
        elif fn == "qz_shift":
            sweep_cx.qz_shift(Hc, 0, 3, (True, False))
        elif fn == "qz_sweep_generate":
            sweep_cx.qz_sweep_generate(Hc, 0, 3, torch.zeros(2, dtype=torch.complex128,
                                                              device="meta"), (True, False))
        elif fn == "rg_chase":
            sweep_rg.rg_chase(H, None, 1, 4, (True, False), want_z=False)
        elif fn == "hess":
            hessenberg.phessenberg_core(H)
        elif fn == "glue":
            glue.glue_products_scan_shift(H, 4, 0, 3, 1, AlgoConfig())
        elif fn == "sweep_generate":
            sweep.sweep_generate(H, 0, 3, [1.0, 0.0, 0.0])
        elif fn == "sweep_left_shard":
            sweep.sweep_left_shard(H[:, :, :2].contiguous(), H, 0, 3, 0)
        elif fn == "sweep_right_shard":
            sweep.sweep_right_shard(H[:, :2].contiguous(), None, H, 0, 3, 0, want_z=False)
        else:
            rgopen.rg_ladder(H, None, "open", 0, 4,
                             torch.zeros(4, dtype=torch.float64, device="meta"),
                             (True, False), want_z=False)
