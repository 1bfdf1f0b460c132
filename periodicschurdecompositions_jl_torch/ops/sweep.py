"""Francis double-shift sweeps of the real periodic QR core.

``chase_sweep`` chases the bulge of one double-shift step down the active
window ``[m, i]`` of a ghost-padded ``(p, N, N)`` cycle (N = n + 1), in
place on H (and Z).  Semantics: ``chase_step`` of the JAX package's
``ops/pqr_real.py`` (reference src/PeriodicSchurDecompositions.jl:806-886).
``chase_sweep_mb`` chases NB such bulges in one pass, bulge b ``gap``
columns behind bulge b-1 (``AlgoConfig.nbulges > 1``; the JAX package's
``chase_sweep_ff_mb``).

* On a CUDA tensor they launch the hand-written kernels of
  ``csrc/sweep.cu`` (they replace the Pallas kernels A, A-mb, B0 and B of
  the JAX package's ``ops/pallas_sweep.py``):

  - ``sweep_generate`` walks k = m..i-1 and generates, in the reference
    order, the bulge reflector of H[0] and the fused 3x3 transform
    F = M3b @ diag(1, M2) of every factor p-1..1; it reads H only, keeps
    a small look-ahead window of each factor in shared memory and applies
    the left transforms right of the window in batches (see the header of
    ``csrc/sweep.cu``); it writes the log R (p, N, 9);
  - ``sweep_generate_mb`` does the same for NB bulges, tick by tick (at
    tick kk bulge b is at k = kk - b*gap), generating the NB bulges'
    transforms of a (tick, factor) at once; a trailing bulge's first
    column comes from the leading 3x3 of the cycle product when it enters
    the window; it reads H only, on look-ahead windows that reach
    (NB-1)*gap rows and columns further up, and writes the log
    R (NB, p, N, 9);
  - ``sweep_left`` applies the logged F^T to rows k..k+2 of every H[f];
  - ``sweep_right`` applies the logged F to columns k..k+2 of H[f-1]
    (rows 0..i; H[p-1] takes factor 0's log) and of Z[f], and writes the
    structural zeros below the (sub)diagonal exactly.  Both stage their
    tiles in shared memory and run the bulges' logs in one pass, bulge b
    two steps behind bulge b-1, which gives each entry the bulge-major
    order (bulge 0's whole log, then bulge 1's) bit for bit.

  Deferring the left and right applications is exact because left and
  right products commute (and, for NB bulges with gap >= 3, because a
  bulge's transform commutes with the later transforms of the bulges
  ahead of it); the reference's forced zeros re-emerge as roundoff, which
  ``sweep_right`` replaces by exact zeros.
* Without T (the core's ``want_t=False``) the row updates stop before
  column ``rhi`` and the column updates of H start at row ``clo`` (the
  active window's bottom + 1 and top; None: unbounded, Z is never
  bounded), as the JAX package's ``tlo``/``thi``; the kernels take the
  bound as whole lines dropped (``psd_sweep_left_bounded``,
  ``psd_sweep_right_bounded``).
* On a CPU tensor they run ``chase_sweep_plain`` / ``chase_sweep_mb_plain``,
  eager torch ports of ``chase_step`` (the reference order, with its forced
  writes; the multi-bulge one in tick order).  Any other device raises.
* Shards (``parallel/sweep_sharded.py``): ``sweep_left_shard`` runs B0 on a
  column shard (p, N, L) of H that holds the global columns c0..c0+L-1,
  ``sweep_right_shard`` runs B on row shards (p, L, N) of H and Z that hold
  the global rows r0..r0+L-1 (structural zeros by global row); the same
  kernels, given a stride and an offset (``psd_sweep_left_shard``,
  ``psd_sweep_right_shard``), so a shard of the whole width at offset 0 is
  bit for bit the unsharded launch.  Their plain version on a CPU shard is
  ``apply_log_shard_plain``.

``launches`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .householder import refl_mat, reflector_small
from .rotations import colsk, rowsk

launches = {"sweep_generate": 0, "sweep_generate_mb": 0, "sweep_left": 0,
            "sweep_right": 0, "sweep_left_shard": 0, "sweep_right_shard": 0}

MAX_NB = 4  # bulges per multi-bulge sweep (csrc/sweep.cu kMaxNb)


def _step(H, Z, k: int, i: int, v, *, want_z: bool, early: bool, log, cst, rhi=None,
          clo=None):
    """One chase step at k in the reference order (in place): the bulge
    reflector of H[0], from ``v`` at the bulge's first step (v is None
    after it: column k-1), then the 3- and 2-reflectors of factors p-1..1.
    ``log``: None or a (p, N, 9) tensor that receives the transforms;
    ``rhi``/``clo``: the want_t=False window (None: unbounded)."""
    mask3, zero = cst
    p = H.shape[0]
    tgt = p - 1 if p > 1 else 0
    nr3 = (i - k + 1) >= 3
    hi_r = min(k + 3, i) + 1
    if v is None:
        col = H[0, k:k + 3, k - 1].clone()
        vk = col
    else:
        vk = v
    if not nr3:
        vk = vk * mask3
    w, tau, beta = reflector_small(vk)
    M3 = refl_mat(w, tau)
    if v is None:
        H[0, k:k + 3, k - 1] = torch.stack(
            [beta, zero, col[2] if k == i - 1 else zero])
    elif early:
        H[0, k, k - 1] *= 1.0 - tau
    rowsk(H[0], k, M3, lo=k, rhi=rhi)
    colsk(H[tgt], k, M3, clo=clo, hi=hi_r)
    if want_z:
        colsk(Z[0], k, M3)
    if log is not None:
        log[0, k] = M3.reshape(9)
    for f in range(p - 1, 0, -1):
        colv = H[f, k:k + 3, k].clone()
        if not nr3:
            colv = colv * mask3
        w2, tau2, beta2 = reflector_small(colv)
        M3b = refl_mat(w2, tau2)
        H[f, k:k + 3, k] = torch.stack([beta2, zero, zero])
        rowsk(H[f], k, M3b, lo=k + 1, rhi=rhi)
        colsk(H[f - 1], k, M3b, clo=clo, hi=hi_r)
        if want_z:
            colsk(Z[f], k, M3b)
        F = M3b
        if nr3:
            xc = H[f, k + 1:k + 3, k + 1].clone()
            wb, taub, betab = reflector_small(xc)
            M2 = refl_mat(wb, taub)
            H[f, k + 1:k + 3, k + 1] = torch.stack([betab, zero])
            rowsk(H[f], k + 1, M2, lo=k + 2, rhi=rhi)
            colsk(H[f - 1], k + 1, M2, clo=clo, hi=hi_r)
            if want_z:
                colsk(Z[f], k + 1, M2)
            F = M3b.clone()
            F[:, 1:] = M3b[:, 1:] @ M2
        if log is not None:
            log[f, k] = F.reshape(9)


def _consts(H):
    dt, dev = H.dtype, H.device
    return (torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev),
            torch.zeros((), dtype=dt, device=dev))


def chase_sweep_plain(H, Z, m: int, i: int, v0, *, want_z: bool,
                      early: bool = False, log=None, rhi=None, clo=None):
    """Eager torch sweep in the reference order (in place on H and Z).

    ``early``: dlahqr early start (``allow_early_qr``): the first
    reflector also scales H[0][m, m-1] by (1 - tau).
    ``log``: optional (p, N, 9) tensor that receives the transforms in
    ``sweep_generate``'s layout (factor 0: M3; factor f: M3b @ diag(1, M2)).
    ``rhi``/``clo``: the want_t=False window: row updates on the columns <
    rhi, H's column updates on the rows >= clo (None: unbounded).
    """
    cst = _consts(H)
    v0 = torch.as_tensor(v0, dtype=H.dtype, device=H.device)
    for k in range(m, i):
        _step(H, Z, k, i, v0 if k == m else None, want_z=want_z, early=early,
              log=log, cst=cst, rhi=rhi, clo=clo)
    return H, Z


def pair_column(h11, h12, h21, h22, h32, rt1r, rt1i, rt2r):
    """First column of (H - s1)(H - s2) e_m at rows m..m+2, scaled as
    dlahqr does (not normalized), for the shifts rt1r +- i rt1i (rt2r =
    rt1r) or the real pair rt1r, rt2r (rt1i = 0)."""
    sv = abs(h11 - rt2r) + abs(rt1i) + abs(h21)
    svs = 1.0 if sv == 0 else sv
    h21s = h21 / svs
    return (h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs) + rt1i * (rt1i / svs),
            h21s * (h11 + h22 - rt1r - rt2r), h21s * h32)


def normalized(v):
    """v / ||v||_1 (v itself when it is zero)."""
    s = abs(v[0]) + abs(v[1]) + abs(v[2])
    s = 1.0 if s == 0 else s
    return [v[0] / s, v[1] / s, v[2] / s]


def lead_v0_plain(H, m: int, sig3):
    """Shifted first column of a trailing bulge entering the window at m:
    from the leading 3x3 of the cycle product H[0] H[1] ... H[p-1] (rows and
    columns m..m+2) and the bulge's shifts ``sig3`` = (rt1r, rt1i, rt2r),
    normalized by its 1-norm (the JAX kernel's ``_lead_v0``, unscaled)."""
    T = torch.eye(3, dtype=H.dtype, device=H.device)
    for f in range(1, H.shape[0]):
        T = T @ H[f, m:m + 3, m:m + 3]
    P = (H[0, m:m + 3, m:m + 3] @ T).tolist()
    v = pair_column(P[0][0], P[0][1], P[1][0], P[1][1], P[2][1], *(float(x) for x in sig3))
    return torch.tensor(normalized(v), dtype=H.dtype, device=H.device)


def chase_sweep_mb_plain(H, Z, m: int, i: int, v0, sig, nbact: int, *, nb: int,
                         gap: int, want_z: bool, log=None, rhi=None, clo=None):
    """Eager torch multi-bulge sweep in tick order (in place on H and Z):
    at tick kk = m .. i + (nbact-1) gap - 1, bulges b = 0..nbact-1 in turn
    take their step at k = kk - b gap when m <= k <= i-1.  Bulge 0 starts
    from ``v0``, bulge b >= 1 from ``lead_v0_plain(H, m, sig[b])`` at its
    first step.  ``sig``: nb shift triples (rt1r, rt1i, rt2r); ``log``:
    optional (nb, p, N, 9) tensor (``sweep_generate_mb``'s layout);
    ``rhi``/``clo``: the want_t=False window, as ``chase_sweep_plain``."""
    check_mb(nb, gap, nbact)
    cst = _consts(H)
    v0 = torch.as_tensor(v0, dtype=H.dtype, device=H.device)
    for kk in range(m, i + (nbact - 1) * gap):
        for b in range(nbact):
            k = kk - b * gap
            if not m <= k <= i - 1:
                continue
            v = None
            if k == m:
                v = v0 if b == 0 else lead_v0_plain(H, m, sig[b])
            _step(H, Z, k, i, v, want_z=want_z, early=False,
                  log=None if log is None else log[b], cst=cst, rhi=rhi, clo=clo)
    return H, Z


def apply_log_plain(H, Z, R, m: int, i: int, *, want_z: bool, nb: int = 1, rhi=None,
                    clo=None):
    """Plain torch version of ``sweep_left`` + ``sweep_right``: apply the
    transform logs of bulges 0..nb-1 (R: (p, N, 9), or (NB, p, N, 9) with
    NB >= nb) to H (and Z) in place: the left products of each bulge in
    turn, then the right products of each bulge in turn, then the exact
    structural zeros.  ``rhi``/``clo``: the want_t=False window (None:
    unbounded): the left products land on the columns < rhi, the right
    products on H's rows >= clo, each with the values of the unbounded
    update; the structural zeros (rows m+1..i, columns < i) lie inside any
    window."""
    p, N, _ = H.shape
    Rb = R.reshape(-1, p, N, 3, 3)
    c0 = max(m - 1, 0)
    nc = N - c0 if rhi is None else rhi - c0
    rlo = 0 if clo is None else clo
    for b in range(nb):
        F = Rb[b]
        for k in range(m, i):
            rows = H[:, k:k + 3, c0:]
            new = F[:, k].transpose(1, 2) @ rows
            if k == m and m >= 1:
                new[0, :, 0] = rows[0, :, 0]  # window-boundary column m-1
            rows[..., :nc].copy_(new[..., :nc])
    for b in range(nb):
        F = Rb[b]
        Fr = torch.roll(F, -1, dims=0)  # H[g] takes the log of factor (g+1) % p
        for k in range(m, i):
            cols = H[:, :i + 1, k:k + 3]
            cols[:, rlo:].copy_((cols @ Fr[:, k])[:, rlo:])
            if want_z:
                zc = Z[:, :, k:k + 3]
                zc.copy_(zc @ F[:, k])
    for r in range(m + 1, i + 1):
        H[0, r, c0:r - 1] = 0.0
        H[1:, r, m:r] = 0.0
    return H, Z


def apply_log_shard_plain(X, Z, R, m: int, i: int, *, side: str, offset: int,
                          want_z: bool = False, nb: int = 1, rhi=None, clo=None):
    """Plain torch version of ``sweep_left_shard`` (``side="left"``) and
    ``sweep_right_shard`` (``side="right"``), in place on a shard.

    left: X is a column shard (p, N, L) of H holding the global columns
    offset..offset+L-1; every bulge's left products on rows m..i+1 of its
    columns >= max(m-1, 0) (and < ``rhi``), factor 0's column m-1 keeping
    its value at step m.  right: X (and Z) are row shards (p, L, N) holding
    the global rows offset..offset+L-1; every bulge's right products on
    columns m..i+1 of H's rows <= i (and >= ``clo``), H[g] taking factor
    (g+1) mod p's log, and of Z's rows, then the structural zeros of H's
    rows m+1..i by global row.  R: (p, N, 9) or (NB, p, N, 9).  Each entry
    goes through the products of ``apply_log_plain`` in its order."""
    p, N = X.shape[0], R.shape[-2]
    Rb = R.reshape(-1, p, N, 3, 3)
    if side == "left":
        L = X.shape[-1]
        lo = max(max(m - 1, 0), offset) - offset
        hi = min(N if rhi is None else rhi, offset + L) - offset
        if hi <= lo:
            return X, Z
        for b in range(nb):
            F = Rb[b]
            for k in range(m, i):
                rows = X[:, k:k + 3, lo:hi]
                new = F[:, k].transpose(1, 2) @ rows
                if k == m and m >= 1 and lo + offset == m - 1:
                    new[0, :, 0] = rows[0, :, 0]  # window-boundary column m-1
                rows.copy_(new)
        return X, Z
    if side != "right":
        raise ValueError(f"side={side!r}: 'left' or 'right'")
    L = X.shape[1]
    lo = max(0 if clo is None else clo, offset) - offset
    hi = min(i + 1, offset + L) - offset
    for b in range(nb):
        F = Rb[b]
        Fr = torch.roll(F, -1, dims=0)  # H[g] takes the log of factor (g+1) % p
        for k in range(m, i):
            if hi > lo:
                cols = X[:, lo:hi, k:k + 3]
                cols.copy_(cols @ Fr[:, k])
            if want_z:
                zc = Z[:, :, k:k + 3]
                zc.copy_(zc @ F[:, k])
    c0 = max(m - 1, 0)
    for r in range(max(m + 1, offset), min(i, offset + L - 1) + 1):
        X[0, r - offset, c0:r - 1] = 0.0
        X[1:, r - offset, m:r] = 0.0
    return X, Z


def _check(name, t, shape, dtype=torch.float64):
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def chase_sweep(H, Z, m: int, i: int, v0, *, want_z: bool, early: bool = False,
                rhi=None, clo=None):
    """One double-shift sweep over the window [m, i], in place.

    Args:
      H: (p, N, N) float64 ghost-padded stack; H[0] Hessenberg, H[1:]
         upper triangular.
      Z: (p, N, N) float64 Schur vector stack, or None when not wanted.
      m, i: window bounds (host ints); the sweep chases k = m..i-1.
      v0: the normalized first shifted column (3 floats).
      want_z: update Z.
      early: dlahqr early start (scale H[0][m, m-1] by 1 - tau).
      rhi, clo: the want_t=False window (None: unbounded): row updates on
         the columns < rhi (i + 1 <= rhi <= N), H's column updates on the
         rows >= clo (0 <= clo <= m); entries outside stay as they were.

    Returns (H, Z).  Entries below the subdiagonal of H[0] and below the
    diagonal of H[1:] within the window are exact zeros on output.
    """
    check_bounds("chase_sweep", m, i, H.shape[1], rhi, clo)
    if H.device.type == "cpu":
        return chase_sweep_plain(H, Z, m, i, v0, want_z=want_z, early=early, rhi=rhi,
                                 clo=clo)
    _check_card_args("chase_sweep", H, Z, m, i, want_z)
    if i == m:
        return H, Z
    R = sweep_generate(H, m, i, v0)
    if early:
        # the first reflector's leading row on column m-1: R[0, m, 0] is
        # exactly 1 - tau (w[0] = 1)
        H[0, m, m - 1] *= R[0, m, 0]
    _apply_log(_cuda.load(), _cuda.stream_ptr(H), H, Z, R, m, i, 1, want_z, rhi, clo)
    return H, Z


def sweep_generate(H, m: int, i: int, v0):
    """Kernel A alone: the transform log R (p, N, 9) of the sweep over
    [m, i] on the CUDA stack H (read only; rows m..i-1 of R are written).
    Its scratch is the carried rows (2 p N doubles), plus the windows when
    p is too large for them to fit in shared memory.  On a CPU stack:
    ``chase_sweep_plain``'s log, H unchanged."""
    if i == m:
        raise ValueError("sweep_generate: empty window")
    p, N, _ = H.shape
    if H.device.type == "cpu":
        R = torch.zeros((p, N, 9), dtype=H.dtype)
        chase_sweep_plain(H.clone(), None, m, i, v0, want_z=False, log=R)
        return R
    _check_card_args("sweep_generate", H, None, m, i, False)
    lib = _cuda.load()
    with _cuda.on_device(H):
        nwork = lib.psd_sweep_generate_scratch(p, N)
        if nwork < 0:
            raise RuntimeError("sweep_generate: CUDA error reading the card's shared "
                               "memory limit")
        work = torch.empty(nwork, dtype=torch.float64, device=H.device)
        R = torch.empty((p, N, 9), dtype=torch.float64, device=H.device)
        v = [float(x) for x in v0]
        _cuda.check(lib.psd_sweep_generate(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                           p, N, m, i, v[0], v[1], v[2],
                                           _cuda.stream_ptr(H)), "sweep_generate")
    launches["sweep_generate"] += 1
    return R


def _check_card_args(name, H, Z, m, i, want_z):
    """Raise ValueError unless H (and Z) are float64 (p, N, N) stacks on
    one CUDA device and [m, i] is a window of them."""
    if H.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {H.device}")
    p, N, _ = H.shape
    _check("H", H, (p, N, N))
    if want_z:
        _check("Z", Z, (p, N, N))
        if Z.device != H.device:
            raise ValueError(f"{name}: H and Z on different devices")
    if not (0 <= m <= i <= N - 2):
        raise ValueError(f"{name}: bad window m={m} i={i} for N={N}")


def check_bounds(name, m, i, n, rhi, clo, clo_max=None):
    """Raise ValueError unless rhi (None or i + 1 .. n) and clo (None or 0
    .. clo_max, default m) bound the window [m, i] of an n-line stack."""
    top = m if clo_max is None else clo_max
    if rhi is not None and not i + 1 <= rhi <= n:
        raise ValueError(f"{name}: rhi={rhi} outside [{i + 1}, {n}]")
    if clo is not None and not 0 <= clo <= top:
        raise ValueError(f"{name}: clo={clo} outside [0, {top}]")


def _apply_log(lib, st, H, Z, R, m, i, nb, want_z, rhi=None, clo=None):
    p, N, _ = H.shape
    with _cuda.on_device(H):
        _cuda.check(lib.psd_sweep_left_bounded(H.data_ptr(), R.data_ptr(), p, N, m, i, nb,
                                               N if rhi is None else int(rhi), st),
                    "sweep_left")
        launches["sweep_left"] += 1
        _cuda.check(lib.psd_sweep_right_bounded(H.data_ptr(),
                                                Z.data_ptr() if want_z else None,
                                                R.data_ptr(), p, N, m, i, nb,
                                                0 if clo is None else int(clo), st),
                    "sweep_right")
    launches["sweep_right"] += 1


def sweep_left_shard(Hc, R, m: int, i: int, offset: int, *, nb: int = 1, rhi=None):
    """Kernel B0 on a column shard, in place: Hc (p, N, L) holds the global
    columns offset..offset+L-1 of the (p, N, N) stack; R the log(s) of the
    sweep over [m, i] (on Hc's device).  ``rhi``: the want_t=False bound
    (columns < rhi).  On a CUDA shard it launches ``psd_sweep_left_shard``
    (no launch when the shard holds no column of the window's rows); on a
    CPU shard ``apply_log_shard_plain``.  Returns Hc."""
    p, N, L = Hc.shape
    chi = N if rhi is None else int(rhi)
    check_bounds("sweep_left_shard", m, i, N, rhi, None)
    if Hc.device.type == "cpu":
        return apply_log_shard_plain(Hc, None, R, m, i, side="left", offset=offset, nb=nb,
                                     rhi=rhi)[0]
    if Hc.device.type != "cuda":
        raise ValueError(f"sweep_left_shard: unsupported device {Hc.device}")
    if R.device != Hc.device:
        raise ValueError(f"sweep_left_shard: the shard on {Hc.device}, the log on {R.device}")
    _check("Hc", Hc, (p, N, L))
    if not (0 <= offset and offset + L <= N and 0 <= m <= i <= N - 2):
        raise ValueError(f"sweep_left_shard: bad shard offset={offset} L={L} or window "
                         f"[{m}, {i}] for N={N}")
    if min(chi, offset + L) <= max(m - 1, 0, offset) or i == m:
        return Hc
    with _cuda.on_device(Hc):
        _cuda.check(_cuda.load().psd_sweep_left_shard(
            Hc.data_ptr(), R.data_ptr(), p, N, m, i, nb, chi, L, offset, L,
            _cuda.stream_ptr(Hc)), "sweep_left_shard")
    launches["sweep_left_shard"] += 1
    return Hc


def sweep_right_shard(Hr, Zr, R, m: int, i: int, offset: int, *, want_z: bool, nb: int = 1,
                      clo=None):
    """Kernel B on row shards, in place: Hr and Zr (p, L, N) hold the global
    rows offset..offset+L-1 of the (p, N, N) stacks (Zr None when not
    wanted); R the log(s) of the sweep over [m, i].  ``clo``: the
    want_t=False bound (H's rows >= clo).  The shard's rows of H get the
    structural zeros by global row.  On a CUDA shard it launches
    ``psd_sweep_right_shard``; on a CPU shard ``apply_log_shard_plain``.
    Returns (Hr, Zr)."""
    p, L, N = Hr.shape
    check_bounds("sweep_right_shard", m, i, N, None, clo)
    if Hr.device.type == "cpu":
        return apply_log_shard_plain(Hr, Zr, R, m, i, side="right", offset=offset,
                                     want_z=want_z, nb=nb, clo=clo)
    if Hr.device.type != "cuda":
        raise ValueError(f"sweep_right_shard: unsupported device {Hr.device}")
    if R.device != Hr.device:
        raise ValueError(f"sweep_right_shard: the shard on {Hr.device}, the log on {R.device}")
    _check("Hr", Hr, (p, L, N))
    if want_z:
        _check("Zr", Zr, (p, L, N))
        if Zr.device != Hr.device:
            raise ValueError("sweep_right_shard: Hr and Zr on different devices")
    if not (0 <= offset and offset + L <= N and 0 <= m <= i <= N - 2):
        raise ValueError(f"sweep_right_shard: bad shard offset={offset} L={L} or window "
                         f"[{m}, {i}] for N={N}")
    if i == m:
        return Hr, Zr
    with _cuda.on_device(Hr):
        _cuda.check(_cuda.load().psd_sweep_right_shard(
            Hr.data_ptr(), Zr.data_ptr() if want_z else None, R.data_ptr(), p, N, m, i, nb,
            0 if clo is None else int(clo), offset, L, _cuda.stream_ptr(Hr)),
            "sweep_right_shard")
    launches["sweep_right_shard"] += 1
    return Hr, Zr


def check_mb(nb: int, gap: int, nbact: int = 1) -> None:
    """Raise ValueError for a multi-bulge configuration the kernels do not
    take: nb in [1, MAX_NB], gap >= 3 (bulge-major deferred application is
    exact only then), 1 <= nbact <= nb."""
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"nbulges={nb}: the multi-bulge sweep takes 1..{MAX_NB} bulges")
    if gap < 3:
        raise ValueError(f"bulge_gap={gap}: bulges must be at least 3 columns apart")
    if not 1 <= nbact <= nb:
        raise ValueError(f"nbact={nbact} active bulges of nb={nb}")


def chase_sweep_mb(H, Z, m: int, i: int, v0, sig, nbact: int, *, nb: int, gap: int,
                   want_z: bool, rhi=None, clo=None):
    """One multi-bulge sweep over the window [m, i], in place.

    Args beyond ``chase_sweep`` (``rhi``/``clo`` as there):
      sig: nb shift triples (rt1r, rt1i, rt2r) in the band's (unscaled)
        domain; bulge 0's is unused (its first column is ``v0``).
      nbact: bulges actually chased, in [1, nb].
      nb: the configured bulge count (``AlgoConfig.nbulges``, <= MAX_NB).
      gap: columns between consecutive bulges (``AlgoConfig.bulge_gap``, >= 3).

    Returns (H, Z), with exact structural zeros as ``chase_sweep``.
    """
    check_mb(nb, gap, nbact)
    check_bounds("chase_sweep_mb", m, i, H.shape[1], rhi, clo)
    if H.device.type == "cpu":
        return chase_sweep_mb_plain(H, Z, m, i, v0, sig, nbact, nb=nb, gap=gap,
                                    want_z=want_z, rhi=rhi, clo=clo)
    _check_card_args("chase_sweep_mb", H, Z, m, i, want_z)
    if len(sig) < nbact:
        raise ValueError(f"chase_sweep_mb: {len(sig)} shift triples for {nbact} bulges")
    if i == m:
        return H, Z
    R = sweep_generate_mb(H, m, i, v0, sig, nbact, nb=nb, gap=gap)
    _apply_log(_cuda.load(), _cuda.stream_ptr(H), H, Z, R, m, i, nbact, want_z, rhi, clo)
    return H, Z


def sweep_generate_mb(H, m: int, i: int, v0, sig, nbact: int, *, nb: int, gap: int):
    """Kernel A-mb alone: the transform logs R (nbact, p, N, 9) of the
    multi-bulge sweep over [m, i] (arguments as ``chase_sweep_mb``; rows
    m..i-1 of each bulge's slice are written).  On a CUDA stack it launches
    the kernel, which reads H only; its scratch is the carried rows (a
    power of two >= (nb-1) gap + 3 per column: 16 p N doubles at nb=4,
    gap 3), plus the windows when they do not fit in shared memory.  On a
    CPU stack: ``chase_sweep_mb_plain``'s logs, H unchanged."""
    check_mb(nb, gap, nbact)
    if len(sig) < nbact:
        raise ValueError(f"sweep_generate_mb: {len(sig)} shift triples for {nbact} bulges")
    p, N, _ = H.shape
    if H.device.type == "cpu":
        R = torch.zeros((nbact, p, N, 9), dtype=H.dtype)
        chase_sweep_mb_plain(H.clone(), None, m, i, v0, sig, nbact, nb=nb, gap=gap,
                             want_z=False, log=R)
        return R
    _check_card_args("sweep_generate_mb", H, None, m, i, False)
    if i == m:
        raise ValueError("sweep_generate_mb: empty window")
    vals = [float(x) for x in v0]
    for b in range(nb):
        vals += [float(x) for x in sig[b]] if b < len(sig) else [0.0] * 3
    shifts = (ctypes.c_double * len(vals))(*vals)
    lib = _cuda.load()
    with _cuda.on_device(H):
        nwork = lib.psd_sweep_generate_mb_scratch(p, N, nb, gap)
        if nwork < 0:
            raise RuntimeError("sweep_generate_mb: CUDA error reading the card's shared "
                               "memory limit")
        work = torch.empty(nwork, dtype=torch.float64, device=H.device)
        R = torch.empty((nbact, p, N, 9), dtype=torch.float64, device=H.device)
        _cuda.check(lib.psd_sweep_generate_mb(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                              p, N, m, i, nb, gap, nbact, shifts,
                                              _cuda.stream_ptr(H)), "sweep_generate_mb")
    launches["sweep_generate_mb"] += 1
    return R
