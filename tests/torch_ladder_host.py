"""JAX-free numpy model of the ladder kernels D (csrc/deflate.cu) and R
(csrc/rgopen.cu).

Both kernels run a serial chain of generations, Givens rotations or
2-reflectors, threaded through the factors of a periodic cycle, each
followed by a 2-row or 2-column update.  The generations read only a small
diagonal *window* of each factor:

* D (``deflate2x2``, rows/columns i-1, i of the ghost-padded (p, N, N) H):
  the 2x2 block W[f] = H[f][i-1:i+1, i-1:i+1];
* R (``rg_ladder`` at j): the 3x3 block H[l][j:j+3, j:j+3] in the open mode,
  the 2x2 block H[l][j:j+2, j:j+2] in the close and chain modes (chain510),
  and in the close mode also H[0][j:j+2, j-1].

Every entry outside the windows takes only row updates (rows of the window,
columns right of it) or only column updates (columns of the window, rows
above it; all rows of Z; in R also H[0]'s rows below the window), in an
order the chain fixes.  So each kernel runs the chain on the windows alone,
logs its rotations, and applies the log to the *lines* outside the windows
afterwards, in parallel:

* D: per round r of chainB (one round for chainA), at most one 2x2 per line;
  a line of H[f]'s row strip is a column c > i of rows i-1, i; of the column
  strip a row r < i-1 of columns i-1, i; of Z[f] every row (the ghost row
  included) of columns i-1, i.
* R: a line of the row strip is a column right of the window (from j+3
  open, j+2 chain510) up to ``rhi``; of the column strip a row of the
  window's columns from ``clo``: above the window in H[l > 0], down to
  ``ilast`` (open) or n-1 (chain510) in H[0]; of Z[g] every row.  Each line
  takes the rotations of one log entry.

Every 2x2 is ``y0 = A x0 + B x1, y1 = C x0 + D x1`` on the pair (x0, x1) of
a line or of a window's row or column.  The kernels write it as the parent
compiled it (its SASS): D ``fma(A, x0, B*x1)``, ``fma(C, x0, D*x1)``; R
``fma(c, x0, s*x1)``, ``fma(c, x1, -(s*x0))``, and D's reflector entries
``1 - tau``, ``-(tau*w1)`` and ``fma(-tau, w1*w1, 1)``.  Here (as on the host
stub of scripts/cuda_host_stub) every operation is rounded on its own.  Two
schedules of this arithmetic are modelled for each kernel:

* ``deflate_parent`` / ``rg_parent``: the design before this one, every
  2-row or 2-column update over whole rows or columns in the chain's order;
* ``deflate_model`` / ``rg_model``: the kernels' schedule, the windows
  staged, the chain on them with a log, then the lines in the kernels'
  order (``deflate_lines``, ``rg_lines``), each with the log entries the
  kernels give it (``deflate_line_op``, ``rg_line_rot``).  A window entry
  that was not staged, a line that reaches into a window or overlaps
  another line fails.

Both schedules give every entry the same operations in the same order, so
they agree bit for bit.
"""
import math

import numpy as np

SFMIN = 2.0 * np.finfo(np.float64).tiny / np.finfo(np.float64).eps
RSFMIN = 1.0 / SFMIN


# ------------------------------------------------ generations (psd_common.cuh)

def _hyp2(x, z):
    m = max(abs(x), abs(z))
    ms = 1.0 if m == 0.0 else m
    xs, zs = x / ms, z / ms
    return m * math.sqrt(xs * xs + zs * zs)


def _neg_copysign(mag, sgn):
    return -abs(mag) if sgn >= 0.0 else abs(mag)


def gen_reflector(alpha, x1):
    """psd::gen_reflector(alpha, x1, 0): (tau, beta, v1)."""
    a1, a2 = abs(x1), 0.0
    m = max(a1, a2)
    ms = 1.0 if m == 0.0 else m
    r1, r2 = a1 / ms, a2 / ms
    rs = math.sqrt(r1 * r1 + r2 * r2)
    xnorm = m * rs
    if xnorm == 0.0:
        tau, beta, scl, den = 0.0, alpha, 0.0, 1.0
    else:
        b = _neg_copysign(_hyp2(alpha, xnorm), alpha)
        ar, scl = alpha, 1.0
        need = abs(b) < SFMIN
        if need:
            scl = RSFMIN
            ar *= RSFMIN
            b = _neg_copysign(_hyp2(ar, (m * RSFMIN) * rs), ar)
        bs = 1.0 if b == 0.0 else b
        tau = (b - ar) / bs
        d = ar - b
        den = 1.0 if d == 0.0 else d
        beta = b * SFMIN if need else b
    v1 = 0.0 if m == 0.0 else (x1 * scl) / den
    return tau, beta, v1


def givens(f, g):
    """psd::givens: (c, s)."""
    af, ag = abs(f), abs(g)
    scale = max(af, ag)
    sc = 1.0 if scale == 0.0 else scale
    fs, gs = f / sc, g / sc
    d = sc * math.sqrt(fs * fs + gs * gs)
    dsafe = 1.0 if d == 0.0 else d
    r = d if f >= 0.0 else -d
    if g == 0.0:
        return 1.0, 0.0
    if f == 0.0:
        return 0.0, (1.0 if g >= 0.0 else -1.0)
    return af / dsafe, g / (1.0 if r == 0.0 else r)


def givens_r(f, g):
    """psd::givens_r: (c, s, r)."""
    if g == 0.0:
        return 1.0, 0.0, f
    if f == 0.0:
        return 0.0, (1.0 if g >= 0.0 else -1.0), abs(g)
    af, ag = abs(f), abs(g)
    sc = max(af, ag)
    fs, gs = f / sc, g / sc
    d = sc * math.sqrt(fs * fs + gs * gs)
    r = d if f >= 0.0 else -d
    return af / d, g / r, r


def op2(M, x0, x1):
    """(A x0 + B x1, C x0 + D x1) for M = (A, B, C, D); scalars or arrays."""
    A, B, C, D = M
    return A * x0 + B * x1, C * x0 + D * x1


def rot(c, s):
    """The 2x2 of a Givens rotation on a pair: (c x0 + s x1, c x1 - s x0)."""
    return (c, s, -s, c)


def _refl_a(tau, w1):
    """chainA's reflector I - tau w w^T, w = (w1, 1), as a line 2x2."""
    m1 = -(tau * w1)
    return (1.0 - tau * (w1 * w1), m1, m1, 1.0 - tau)


def _refl_b(tau, w1):
    """chainB's reflector, w = (1, w1)."""
    m1 = -(tau * w1)
    return (1.0 - tau, m1, m1, 1.0 - tau * (w1 * w1))


# ------------------------------------------------------------------- lines

class _Window:
    """Staged window entries of a stack: (f, r, c) -> value."""

    def __init__(self, X, cells):
        self.cells = set(cells)
        self.v = {k: float(X[k]) for k in self.cells}

    def __getitem__(self, k):
        assert k in self.v, f"window entry {k} was not staged"
        return self.v[k]

    def __setitem__(self, k, x):
        assert k in self.v, f"window entry {k} was not staged"
        self.v[k] = x

    def pair(self, a, b, M):
        self[a], self[b] = op2(M, self[a], self[b])

    def write_back(self, X):
        for k, x in self.v.items():
            X[k] = x


def _apply_lines(X, lines, ops, window):
    """Each line: its entries (f, r, c), its ops a list of (M, (a, b)) on
    positions of the line.  Every line is loaded first (the kernels load
    theirs while the chain runs), then takes its ops in order, then is
    stored; no line may reach into a window or overlap another line."""
    seen = set()
    for k, cells in enumerate(lines):
        for cell in cells:
            assert cell not in window, f"line {k} reaches into the window at {cell}"
            assert cell not in seen, f"line {k} overlaps another line at {cell}"
            seen.add(cell)
    vals = [np.array([X[c] for c in cells]) for cells in lines]
    for k in range(len(lines)):
        for M, (a, b) in ops[k]:
            vals[k][a], vals[k][b] = op2(M, vals[k][a], vals[k][b])
    for k, cells in enumerate(lines):
        for cell, x in zip(cells, vals[k]):
            X[cell] = x


# ------------------------------------------------------------------ kernel D

def _d_rows2(A, k0, lo, M):
    x, y = A[k0, lo:].copy(), A[k0 + 1, lo:].copy()
    A[k0, lo:], A[k0 + 1, lo:] = op2(M, x, y)


def _d_cols2(A, j0, hi, M):
    a, b = A[:hi, j0].copy(), A[:hi, j0 + 1].copy()
    # (a, b) <- (a, b) M: the line 2x2 of M is its transpose
    A[:hi, j0], A[:hi, j0 + 1] = op2((M[0], M[2], M[1], M[3]), a, b)


def deflate_parent(H, Z, i, jmin, jmax, cs0, sn0, replace0, finzero, thr):
    """The parent kernel D's order on copies of H and Z (Z may be None);
    returns (H, Z, rounds)."""
    H = np.array(H, dtype=np.float64)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p = H.shape[0]
    if jmin >= 1:
        for f in range(jmin - 1):
            tau, beta, w1 = gen_reflector(H[f, i, i], H[f, i, i - 1])
            M = _refl_a(tau, w1)
            H[f, i, i - 1], H[f, i, i] = 0.0, beta
            _d_cols2(H[f], i - 1, i, M)
            _d_rows2(H[f + 1], i - 1, i - 1, M)
            if Z is not None:
                _d_cols2(Z[f + 1], i - 1, Z.shape[1], M)
        return H, Z, 1
    tgt = p - 1 if p > 1 else 0
    replace = bool(replace0)
    rounds = 0
    while rounds < 20:
        rounds += 1
        c, s = givens(H[0, i - 1, i - 1], H[0, i, i - 1]) if replace else (cs0, sn0)
        _d_rows2(H[0], i - 1, i - 1, (c, s, -s, c))
        _d_cols2(H[tgt], i - 1, i + 1, (c, -s, s, c))
        if Z is not None:
            _d_cols2(Z[0], i - 1, Z.shape[1], (c, -s, s, c))
        for f in range(p - 1, max(jmax, 0), -1):
            tau, beta, w1 = gen_reflector(H[f, i - 1, i - 1], H[f, i, i - 1])
            M = _refl_b(tau, w1)
            H[f, i - 1, i - 1], H[f, i, i - 1] = beta, 0.0
            _d_rows2(H[f], i - 1, i, M)
            _d_cols2(H[f - 1], i - 1, i + 1, M)
            if Z is not None:
                _d_cols2(Z[f], i - 1, Z.shape[1], M)
        done = (not replace) or abs(H[0, i, i - 1]) < thr
        replace = True
        if done:
            break
    if finzero:
        H[0, i, i - 1] = 0.0
    if jmax >= 1:
        H[jmax, i, i - 1] = 0.0
    return H, Z, rounds


def deflate_lines(p, N, i, want_z):
    """The kernel's lines of one factor stack, in its order: per factor f the
    row strip (columns i+1..N-1 of rows i-1, i), the column strip (rows
    0..i-2 of columns i-1, i), then Z's rows 0..N-1: (kind, f, index)."""
    out = []
    for f in range(p):
        out += [(0, f, c) for c in range(i + 1, N)]
        out += [(1, f, r) for r in range(i - 1)]
        if want_z:
            out += [(2, f, r) for r in range(N)]
    return out


def deflate_line_op(kind, f, p, jmin, jmax, log):
    """The 2x2 a line of (kind, f) takes from one round's log (None: none):
    log[0] the round's (c, s) (chainB), log[g] factor g's reflector."""
    if jmin >= 1:  # chainA: reflector f-1 on H[f]'s rows and Z[f], f on H[f]'s columns
        g = f if kind == 1 else f - 1
        return log[g] if 0 <= g <= jmin - 2 else None
    fmin = max(1, jmax + 1)
    tgt = p - 1 if p > 1 else 0
    g = f + 1 if kind == 1 else f
    if (kind == 1 and f == tgt) or (kind != 1 and f == 0):
        return rot(*log[0])
    return log[g] if fmin <= g <= p - 1 else None


def deflate_model(H, Z, i, jmin, jmax, cs0, sn0, replace0, finzero, thr):
    """Kernel D's schedule on copies of H and Z: (H, Z, rounds)."""
    H = np.array(H, dtype=np.float64)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, N, _ = H.shape
    W = _Window(H, [(f, i - 1 + a, i - 1 + b) for f in range(p) for a in (0, 1)
                    for b in (0, 1)])

    def w(f, a, b):
        return (f, i - 1 + a, i - 1 + b)

    def rows(f, cols, M):  # the window's part of a 2-row update
        for b in cols:
            W.pair(w(f, 0, b), w(f, 1, b), M)

    def cols(f, rws, M):   # of a 2-column update
        for a in rws:
            W.pair(w(f, a, 0), w(f, a, 1), (M[0], M[2], M[1], M[3]))

    logs = []   # one log per round; a slot is written once per round
    if jmin >= 1:
        log = {}
        for f in range(jmin - 1):
            tau, beta, w1 = gen_reflector(W[w(f, 1, 1)], W[w(f, 1, 0)])
            log[f] = M = _refl_a(tau, w1)
            W[w(f, 1, 0)], W[w(f, 1, 1)] = 0.0, beta
            cols(f, (0,), M)
            rows(f + 1, (0, 1), M)
        logs.append(log)
    else:
        tgt = p - 1 if p > 1 else 0
        replace = bool(replace0)
        for _ in range(20):
            c, s = givens(W[w(0, 0, 0)], W[w(0, 1, 0)]) if replace else (cs0, sn0)
            log = {0: (c, s)}
            rows(0, (0, 1), rot(c, s))
            cols(tgt, (0, 1), (c, -s, s, c))
            for f in range(p - 1, max(jmax, 0), -1):
                tau, beta, w1 = gen_reflector(W[w(f, 0, 0)], W[w(f, 1, 0)])
                log[f] = M = _refl_b(tau, w1)
                W[w(f, 0, 0)], W[w(f, 1, 0)] = beta, 0.0
                rows(f, (1,), M)
                cols(f - 1, (0, 1), M)
            logs.append(log)
            done = (not replace) or abs(W[w(0, 1, 0)]) < thr
            replace = True
            if done:
                break
        if finzero:
            W[w(0, 1, 0)] = 0.0
        if jmax >= 1:
            W[w(jmax, 1, 0)] = 0.0
    # the lines: every round's 2x2 in round order
    for X, lines in ((H, [ln for ln in deflate_lines(p, N, i, False)]),
                     (Z, [ln for ln in deflate_lines(p, N, i, True) if ln[0] == 2])):
        if X is None:
            continue
        cells, ops = [], []
        for kind, f, k in lines:
            cells.append(((f, i - 1, k), (f, i, k)) if kind == 0 else
                         ((f, k, i - 1), (f, k, i)))
            seq = []
            for log in logs:
                M = deflate_line_op(kind, f, p, jmin, jmax, log)
                if M is not None:
                    seq.append((M, (0, 1)))
            ops.append(seq)
        _apply_lines(X, cells, ops, W.cells if X is H else set())
    W.write_back(H)
    return H, Z, len(logs)


# ------------------------------------------------------------------ kernel R

def _r_rows2(M, n, k, lo, hi, c, s):
    lo, hi = max(lo, 0), min(hi, n)
    if lo < hi:
        x0, x1 = M[k, lo:hi].copy(), M[k + 1, lo:hi].copy()
        M[k, lo:hi], M[k + 1, lo:hi] = op2(rot(c, s), x0, x1)


def _r_cols2(M, n, k, lo, hi, c, s):
    lo, hi = max(lo, 0), min(hi, n)
    if lo < hi:
        x0, x1 = M[lo:hi, k].copy(), M[lo:hi, k + 1].copy()
        M[lo:hi, k], M[lo:hi, k + 1] = op2(rot(c, s), x0, x1)


def rg_parent(H, Z, mode, j, ilast, rotn, S, rhi=None, clo=None):
    """The parent kernel R's order on copies of H and Z (Z may be None)."""
    H = np.array(H, dtype=np.float64)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, n, _ = H.shape
    rhi = n if rhi is None else rhi
    clo = 0 if clo is None else clo
    c1, s1, c2, s2 = (float(x) for x in rotn)
    if mode == "open":
        _r_cols2(H[0], n, j + 1, clo, ilast + 1, c2, s2)
        _r_cols2(H[0], n, j, clo, ilast + 1, c1, s1)
        if Z is not None:
            _r_cols2(Z[1 % p], n, j + 1, 0, n, c2, s2)
            _r_cols2(Z[1 % p], n, j, 0, n, c1, s1)
        for l in range(1, p):
            Hl = H[l]
            if S[l]:
                _r_rows2(Hl, n, j + 1, j, rhi, c2, s2)
                c2, s2, r = givens_r(Hl[j + 2, j + 2], -Hl[j + 2, j + 1])
                Hl[j + 2, j + 2], Hl[j + 2, j + 1] = r, 0.0
                _r_cols2(Hl, n, j + 1, clo, j + 2, c2, s2)
                _r_rows2(Hl, n, j, j, rhi, c1, s1)
                c1, s1, r = givens_r(Hl[j + 1, j + 1], -Hl[j + 1, j])
                Hl[j + 1, j + 1], Hl[j + 1, j] = r, 0.0
                _r_cols2(Hl, n, j, clo, j + 1, c1, s1)
            else:
                _r_cols2(Hl, n, j + 1, clo, j + 3, c2, s2)
                c2, s2, r = givens_r(Hl[j + 1, j + 1], Hl[j + 2, j + 1])
                Hl[j + 1, j + 1], Hl[j + 2, j + 1] = r, 0.0
                _r_rows2(Hl, n, j + 1, j + 2, rhi, c2, s2)
                _r_cols2(Hl, n, j, clo, j + 2, c1, s1)
                c1, s1, r = givens_r(Hl[j, j], Hl[j + 1, j])
                Hl[j, j], Hl[j + 1, j] = r, 0.0
                _r_rows2(Hl, n, j, j + 1, rhi, c1, s1)
            if Z is not None:
                Zl = Z[(l + 1) % p]
                _r_cols2(Zl, n, j + 1, 0, n, c2, s2)
                _r_cols2(Zl, n, j, 0, n, c1, s1)
        _r_rows2(H[0], n, j + 1, j, rhi, c2, s2)
        _r_rows2(H[0], n, j, j, rhi, c1, s1)
        return H, Z
    if mode == "close":
        c1, s1, r = givens_r(H[0, j, j - 1], H[0, j + 1, j - 1])
        H[0, j, j - 1], H[0, j + 1, j - 1] = r, 0.0
    _r_rows2(H[0], n, j, j, rhi, c1, s1)
    if Z is not None:
        _r_cols2(Z[0], n, j, 0, n, c1, s1)
    for l in range(p - 1, 0, -1):
        Hl = H[l]
        if S[l]:
            _r_cols2(Hl, n, j, clo, j + 2, c1, s1)
            c1, s1, r = givens_r(Hl[j, j], Hl[j + 1, j])
            Hl[j, j], Hl[j + 1, j] = r, 0.0
            _r_rows2(Hl, n, j, j + 1, rhi, c1, s1)
        else:
            _r_rows2(Hl, n, j, j, rhi, c1, s1)
            c1, s1, r = givens_r(Hl[j + 1, j + 1], -Hl[j + 1, j])
            Hl[j + 1, j + 1], Hl[j + 1, j] = r, 0.0
            _r_cols2(Hl, n, j, clo, j + 1, c1, s1)
        if Z is not None:
            _r_cols2(Z[l], n, j, 0, n, c1, s1)
    _r_cols2(H[0], n, j, clo, n, c1, s1)
    return H, Z


def rg_lines(p, n, mode, j, ilast, rhi, clo, want_z):
    """The kernel's lines, in its order: per factor l the row strip (columns
    j+K..rhi-1 of rows j..j+K-1), the column strip (rows of columns
    j..j+K-1: clo..j-1 for l > 0, for l = 0 clo..ilast (open) or clo..n-1
    (chain510) without the window's rows), then Z[l]'s rows 0..n-1, with K
    = 3 (open) or 2: (kind, l, index)."""
    K = 3 if mode == "open" else 2
    rhi, clo = min(n, rhi), max(0, clo)
    out = []
    for l in range(p):
        out += [(0, l, c) for c in range(j + K, rhi)]
        hi = j if l > 0 else (min(ilast + 1, n) if mode == "open" else n)
        out += [(1, l, r) for r in range(clo, hi) if not j <= r < j + K]
        if want_z:
            out += [(2, l, r) for r in range(n)]
    return out


def rg_line_rot(kind, l, p, mode, S):
    """The log entry a line of (kind, l) takes: the open mode's rot[e] is
    (c1, s1, c2, s2) after factor e (rot[0] the input), chain510's g[e] the
    rotation factor e made (g[0] the first)."""
    if mode == "open":
        if kind == 2:
            return (l - 1) % p
        if l == 0:
            return p - 1 if kind == 0 else 0
        return l - 1 if (kind == 0) == bool(S[l]) else l
    if kind == 2:
        return l
    if l == 0:
        return 0 if kind == 0 else 1
    inc = 0 if l == p - 1 else l + 1
    return l if (kind == 0) == bool(S[l]) else inc


def rg_model(H, Z, mode, j, ilast, rotn, S, rhi=None, clo=None):
    """Kernel R's schedule on copies of H and Z (Z may be None)."""
    H = np.array(H, dtype=np.float64)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, n, _ = H.shape
    rhi = n if rhi is None else rhi
    clo = 0 if clo is None else clo
    K = 3 if mode == "open" else 2
    cells = [(l, j + a, j + b) for l in range(p) for a in range(K) for b in range(K)]
    if mode == "close":
        cells += [(0, j, j - 1), (0, j + 1, j - 1)]
    W = _Window(H, cells)
    rhic, cloc = min(rhi, n), max(clo, 0)

    def rows(l, a, lo, hi, c, s):   # rows j+a, j+a+1, columns [lo, hi) of the window
        for b in range(K):
            if max(lo, j) <= j + b < min(hi, rhic):
                W.pair((l, j + a, j + b), (l, j + a + 1, j + b), rot(c, s))

    def cols(l, b, lo, hi, c, s):   # columns j+b, j+b+1, rows [lo, hi)
        for a in range(K):
            if max(lo, cloc) <= j + a < min(hi, n):
                W.pair((l, j + a, j + b), (l, j + a, j + b + 1), rot(c, s))

    if mode == "open":
        c1, s1, c2, s2 = (float(x) for x in rotn)
        log = {0: (c1, s1, c2, s2)}
        cols(0, 1, clo, ilast + 1, c2, s2)
        cols(0, 0, clo, ilast + 1, c1, s1)
        for l in range(1, p):
            if S[l]:
                rows(l, 1, j, rhi, c2, s2)
                c2, s2, r = givens_r(W[(l, j + 2, j + 2)], -W[(l, j + 2, j + 1)])
                W[(l, j + 2, j + 2)], W[(l, j + 2, j + 1)] = r, 0.0
                cols(l, 1, clo, j + 2, c2, s2)
                rows(l, 0, j, rhi, c1, s1)
                c1, s1, r = givens_r(W[(l, j + 1, j + 1)], -W[(l, j + 1, j)])
                W[(l, j + 1, j + 1)], W[(l, j + 1, j)] = r, 0.0
                cols(l, 0, clo, j + 1, c1, s1)
            else:
                cols(l, 1, clo, j + 3, c2, s2)
                c2, s2, r = givens_r(W[(l, j + 1, j + 1)], W[(l, j + 2, j + 1)])
                W[(l, j + 1, j + 1)], W[(l, j + 2, j + 1)] = r, 0.0
                rows(l, 1, j + 2, rhi, c2, s2)
                cols(l, 0, clo, j + 2, c1, s1)
                c1, s1, r = givens_r(W[(l, j, j)], W[(l, j + 1, j)])
                W[(l, j, j)], W[(l, j + 1, j)] = r, 0.0
                rows(l, 0, j + 1, rhi, c1, s1)
            log[l] = (c1, s1, c2, s2)
        rows(0, 1, j, rhi, c2, s2)
        rows(0, 0, j, rhi, c1, s1)

        def seq(e):   # pair (1, 2) by (c2, s2), then (0, 1) by (c1, s1)
            a1, b1, a2, b2 = log[e]
            return [(rot(a2, b2), (1, 2)), (rot(a1, b1), (0, 1))]
    else:
        if mode == "close":
            c1, s1, r = givens_r(W[(0, j, j - 1)], W[(0, j + 1, j - 1)])
            W[(0, j, j - 1)], W[(0, j + 1, j - 1)] = r, 0.0
        else:
            c1, s1 = float(rotn[0]), float(rotn[1])
        log = {0: (c1, s1)}
        rows(0, 0, j, rhi, c1, s1)
        for l in range(p - 1, 0, -1):
            if S[l]:
                cols(l, 0, clo, j + 2, c1, s1)
                c1, s1, r = givens_r(W[(l, j, j)], W[(l, j + 1, j)])
                W[(l, j, j)], W[(l, j + 1, j)] = r, 0.0
                rows(l, 0, j + 1, rhi, c1, s1)
            else:
                rows(l, 0, j, rhi, c1, s1)
                c1, s1, r = givens_r(W[(l, j + 1, j + 1)], -W[(l, j + 1, j)])
                W[(l, j + 1, j + 1)], W[(l, j + 1, j)] = r, 0.0
                cols(l, 0, clo, j + 1, c1, s1)
            log[l] = (c1, s1)
        cols(0, 0, clo, n, c1, s1)

        def seq(e):
            return [(rot(*log[e]), (0, 1))]
    for X, want in ((H, False), (Z, True)):
        if X is None:
            continue
        lines = [ln for ln in rg_lines(p, n, mode, j, ilast, rhi, clo, want)
                 if (ln[0] == 2) == want]
        cl = [tuple((l, j + a, k) for a in range(K)) if kind == 0 else
              tuple((l, k, j + b) for b in range(K)) for kind, l, k in lines]
        ops = [seq(rg_line_rot(kind, l, p, mode, S)) for kind, l, _ in lines]
        _apply_lines(X, cl, ops, W.cells if X is H else set())
    W.write_back(H)
    return H, Z
