"""JAX-free numpy model of kernel A-mb's batched schedule (csrc/sweep.cu).

Kernel A-mb generates the transform logs R (NB, p, N, 9) of one multi-bulge
sweep over the window [m, i] of a ghost-padded (p, N, N) cycle: bulge b
trails bulge b-1 by ``gap`` columns, at tick kk it takes its step at
k = kk - b gap (m <= k <= i-1), ticks kk = m .. i + (nbact-1) gap - 1.  Two
schedules of the same arithmetic are modelled here, in float64 numpy with
one rounding per operation (no fused multiply-add):

* ``sweep_log_mb_full``: the order of the kernel before the look-ahead
  window, on a full working copy.  Per tick, factor 0 and then factors
  p-1..1: the tick's bulges generate (factor 0 of a bulge at its first step
  from v0, or for a trailing bulge from the leading 3x3 of the cycle
  product, ``lead_v0``; later from column k-1, whose forced entries
  (beta, 0, keep) it writes back, keep being the entry at row k+2 when
  k == i-1), then each bulge's left transform on rows k..k+2 (factor f >= 1:
  column k takes its exact image (beta, 0, 0), column k+1 the second
  reflector's), then the band right transform on columns k..k+2 of the
  next factor's rows max(m, k - lowext)..min(k+3, i), lowext = (nb-1) gap
  from the configured nb.  With p == 1 the band update lands on the factor
  whose rows the next bulge's left update reads, so there the bulges go one
  at a time (left, right, next bulge).
* ``sweep_log_mb_windowed``: the look-ahead window.  Ticks go in batches of
  L.  For a batch kk0..kk1-1 each factor keeps the block of rows
  T..kk0+L+2 and columns T-1..kk0+L+1, T = max(m, kk0 - lowext), both cut
  at i+1: every entry that the batch's generations and ``lead_v0`` read
  and that its transforms write on the way there.  Band rows above T are
  left out: they lie above every bulge's rows for the rest of the sweep, so
  no generation reads them again.  The columns right of the block receive
  no right transform in the batch, so their left transforms are applied at
  the batch's end, per column in tick order (each tick's bulges in bulge
  order; their rows are disjoint): each column carries its lowext + 2 rows
  still in flux, max(m, kk0 - lowext)..kk0+1 on entry and
  max(m, kk1 - lowext)..kk1+1 on exit, and takes the rows below them fresh
  from H, which no transform has touched there.  The next batch's block is
  this one's lower right part (the block moves down and right by L), the
  carried rows of the columns that enter it, and fresh rows of H.

Every entry of the block sees the same operations in the same order in
both schedules, so the logs agree bit for bit.  Entries that the window
never loads are NaN, so a read outside the extents shows in the log; the
index asserts state the extents.  Columns right of i+1 are never read by a
generation and are not visited.
"""
import numpy as np

from torch_window_host import apply_f, apply_ft, gen_fused, gen_reflector, refl_mat3


def gen_bulge(x0, x1, x2, nr3):
    """Factor 0's bulge reflector M3 (9 entries, row-major) and beta."""
    tau, beta, w1, w2 = gen_reflector(x0, x1, x2 if nr3 else 0.0)
    return refl_mat3(tau, w1, w2), beta


def gen_factor(c0, c1, nr3):
    """Factor f >= 1: the fused F = M3b diag(1, M2) of columns k (``c0``) and
    k+1 (``c1``), rows k..k+2, with beta (column k's image) and betab."""
    beta = gen_reflector(c0[0], c0[1], c0[2] if nr3 else 0.0)[1]
    F, betab = gen_fused(c0, c1, nr3)
    return F, beta, betab


def lead_v0(get, p, m, sg):
    """Shifted first column of a trailing bulge entering at m: from the
    leading 3x3 of the cycle product C[0] C[1] ... C[p-1] (rows and columns
    m..m+2, read through ``get(f, r, c)``) and the shifts sg = (rt1r, rt1i,
    rt2r), normalized by its 1-norm; csrc/sweep.cu's lead_v0 term by term."""
    T = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    for f in range(1, p):
        B = [[get(f, m + r, m + c) for c in range(3)] for r in range(3)]
        T = [T[r * 3] * B[0][c] + T[r * 3 + 1] * B[1][c] + T[r * 3 + 2] * B[2][c]
             for r in range(3) for c in range(3)]
    A = [[get(0, m + r, m + c) for c in range(3)] for r in range(3)]
    P = [A[r][0] * T[c] + A[r][1] * T[3 + c] + A[r][2] * T[6 + c]
         for r in range(3) for c in range(2)]
    h11, h12, h21, h22, h32 = P[0], P[1], P[2], P[3], P[5]
    rt1r, rt1i, rt2r = (float(x) for x in sg)
    sv = abs(h11 - rt2r) + abs(rt1i) + abs(h21)
    svs = 1.0 if sv == 0.0 else sv
    h21s = h21 / svs
    v1 = h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs)
    v1 = v1 + rt1i * (rt1i / svs)
    v2 = h21s * (((h11 + h22) - rt1r) - rt2r)
    v3 = h21s * h32
    sn = abs(v1) + abs(v2) + abs(v3)
    sns = 1.0 if sn == 0.0 else sn
    return v1 / sns, v2 / sns, v3 / sns


class _Full:
    """Rows and columns in global coordinates on a full copy of H."""

    def __init__(self, H):
        self.A = H.copy()

    def get(self, f, r, c):
        return self.A[f, r, c]

    def rows(self, f, r, c0, c1):
        return self.A[f, r, c0:c1 + 1].copy()

    def put(self, f, r, c0, vals):
        self.A[f, r, c0:c0 + len(vals)] = vals


class _Window:
    """Each factor's block of S x S entries; entry (r, c) at
    (r - base, c - base + 1).  Reads and writes outside the extents set by
    ``place`` (rows top..rlast, columns top-1..clast) fail."""

    def __init__(self, p, S):
        self.S = S
        self.W = np.full((p, S, S), np.nan)

    def place(self, base, top, rlast, clast):
        assert rlast - base < self.S and clast - base + 1 < self.S
        self.base, self.top, self.rlast, self.clast = base, top, rlast, clast

    def _ab(self, r, c):
        assert self.top <= r <= self.rlast and self.top - 1 <= c <= self.clast, (r, c)
        return r - self.base, c - self.base + 1

    def get(self, f, r, c):
        return self.W[(f, *self._ab(r, c))]

    def rows(self, f, r, c0, c1):
        a, b0 = self._ab(r, c0)
        self._ab(r, c1)
        return self.W[f, a, b0:b0 + c1 - c0 + 1].copy()

    def put(self, f, r, c0, vals):
        a, b0 = self._ab(r, c0)
        self._ab(r, c0 + len(vals) - 1)
        self.W[f, a, b0:b0 + len(vals)] = vals


def _left(st, f, k, cl, cmax, F, forced):
    """F^T on rows k..k+2 of columns cl..cmax; ``forced``: (column, row
    offset, value) entries written instead of the transform's."""
    o = list(apply_ft(F, *(st.rows(f, k + d, cl, cmax) for d in range(3))))
    for c, d, val in forced:
        o[d][c - cl] = val
    for d in range(3):
        st.put(f, k + d, cl, o[d])


def _right(st, tgt, k, rlo, i, F):
    """F on columns k..k+2 of rows rlo..min(k+3, i) of factor ``tgt``."""
    for r in range(rlo, min(k + 3, i) + 1):
        st.put(tgt, r, k, list(apply_f(F, *(st.get(tgt, r, k + d) for d in range(3)))))


def _ticks(st, R, Fs, kk0, kk1, m, i, v0, sig, nb, gap, nbact, cmax, top):
    """Ticks kk0..kk1-1 on the store ``st``: left transforms reach columns
    up to ``cmax``, band updates rows from ``top`` down.  Fs[f, b, kk] gets
    bulge b's transform of factor f at tick kk."""
    p = R.shape[1]
    lowext = (nb - 1) * gap
    tgt0 = p - 1 if p > 1 else 0
    for kk in range(kk0, kk1):
        act = [(b, kk - b * gap) for b in range(nbact) if m <= kk - b * gap < i]
        Fb = {}
        for b, k in act:  # factor 0: the bulges' reflectors
            nr3 = (i - k + 1) >= 3
            if k > m:
                x = [st.get(0, k + d, k - 1) for d in range(3)]
                keep = x[2] if k == i - 1 else 0.0
            elif b == 0:
                x = list(v0)
            else:
                x = lead_v0(st.get, p, m, sig[b])
            Fb[b], beta = gen_bulge(*x, nr3)
            R[b, 0, k] = Fb[b]
            Fs[0, b, kk] = Fb[b]
            if k > m:  # the forced bulge column, read by the next bulge
                for d, val in enumerate((beta, 0.0, keep)):
                    st.put(0, k + d, k - 1, [val])
        for grp in ([act] if p > 1 else [[a] for a in act]):
            for b, k in grp:
                _left(st, 0, k, k, cmax, Fb[b], ())
            for b, k in grp:
                _right(st, tgt0, k, max(top, k - lowext), i, Fb[b])
        for f in range(p - 1, 0, -1):
            gens = {}
            for b, k in act:
                nr3 = (i - k + 1) >= 3
                gens[b] = gen_factor([st.get(f, k + d, k) for d in range(3)],
                                     [st.get(f, k + d, k + 1) for d in range(3)], nr3)
                R[b, f, k] = gens[b][0]
                Fs[f, b, kk] = gens[b][0]
            for b, k in act:
                F, beta, betab = gens[b]
                forced = [(k, 0, beta), (k, 1, 0.0), (k, 2, 0.0)]
                if (i - k + 1) >= 3:
                    forced += [(k + 1, 1, betab), (k + 1, 2, 0.0)]
                _left(st, f, k, k, cmax, F, forced)
            for b, k in act:
                _right(st, f - 1, k, max(top, k - lowext), i, gens[b][0])


def _setup(H, m, i, sig, nb, gap, nbact):
    assert 1 <= nbact <= nb and gap >= 3 and 0 <= m < i <= H.shape[1] - 2
    assert len(sig) >= nbact
    p, N, _ = H.shape
    return np.full((nb, p, N, 9), np.nan), i + (nbact - 1) * gap


def sweep_log_mb_full(H, m, i, v0, sig, nb, gap, nbact):
    """The logs of the order before the look-ahead window on a full working
    copy, and the working copy at the end."""
    R, kkend = _setup(H, m, i, sig, nb, gap, nbact)
    st = _Full(H)
    _ticks(st, R, {}, m, kkend, m, i, v0, sig, nb, gap, nbact, H.shape[1] - 1, m)
    return R, st.A


def sweep_log_mb_windowed(H, m, i, v0, sig, nb, gap, nbact, L, carry_rows=None):
    """The logs of the batched schedule with batch length L; also returns
    the last batch's blocks (p, S, S), S = L + lowext + 3, and their base
    row (entry (r, c) at (r - base, c - base + 1)).  ``carry_rows``: rows
    each column right of a block carries to the next batch, lowext + 2 unless
    set (fewer shows as NaN)."""
    R, kkend = _setup(H, m, i, sig, nb, gap, nbact)
    assert L >= 1
    p, N, _ = H.shape
    lowext = (nb - 1) * gap
    keep = lowext + 2 if carry_rows is None else carry_rows
    win = _Window(p, L + lowext + 3)
    carry = np.full((p, N, N), np.nan)  # rows in flux of the columns right of a block
    carry[:, m:m + 2] = H[:, m:m + 2]   # nothing has touched them yet
    kk0 = m
    rlast, clast = min(kk0 + L + 2, i + 1), min(kk0 + L + 1, i + 1)
    win.place(kk0 - lowext, m, rlast, clast)
    for f in range(p):  # the first block: column m-1 is never read
        for r in range(m, rlast + 1):
            win.put(f, r, m, H[f, r, m:clast + 1])
    while True:
        kk1 = min(kk0 + L, kkend)
        top = max(m, kk0 - lowext)
        Fs = {}
        _ticks(win, R, Fs, kk0, kk1, m, i, v0, sig, nb, gap, nbact, clast, top)
        if kk1 == kkend:
            return R, win.W, win.base
        # the batch's left transforms on the columns right of the block
        for f in range(p):
            for c in range(clast + 1, i + 2):
                x = carry[f, :, c].copy()
                x[kk0 + 2:kk1 + 2] = H[f, kk0 + 2:kk1 + 2, c]
                for kk in range(kk0, kk1):
                    for b in range(nbact):
                        k = kk - b * gap
                        if m <= k < i:
                            x[k:k + 3] = apply_ft(Fs[f, b, kk], *x[k:k + 3])
                carry[f, :, c] = np.nan
                lo = max(m, kk1 + 2 - keep)
                carry[f, lo:kk1 + 2, c] = x[lo:kk1 + 2]
        # the next block: this one's lower right part, the carried rows of
        # the columns that enter it, fresh rows of H
        old, (rold, cold) = win.W.copy(), (rlast, clast)
        kk0 = kk1
        base, top = kk0 - lowext, max(m, kk0 - lowext)
        rlast, clast = min(kk0 + L + 2, i + 1), min(kk0 + L + 1, i + 1)
        win.W[:] = np.nan
        win.place(base, top, rlast, clast)
        for f in range(p):
            for c in range(max(top - 1, m), clast + 1):  # column m-1 is never read
                for r in range(top, rlast + 1):
                    if r <= rold and c <= cold:
                        val = old[f, r - base + L, c - base + 1 + L]
                    elif c > cold and r <= kk0 + 1:
                        val = carry[f, r, c]
                    else:
                        val = H[f, r, c]
                    win.put(f, r, c, [val])
