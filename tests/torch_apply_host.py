"""JAX-free numpy model of the apply kernels B0 and B (csrc/sweep.cu).

B0 (``sweep_left``) and B (``sweep_right``) apply the transform logs R
(NB, p, N, 9) of a double-shift sweep over the window [m, i] to the
ghost-padded (p, N, N) stacks H and Z.  Both walk *lines* along the
*positions* m..i+1: B0 the columns >= max(m-1, 0) of every H[f] down their
rows (log of factor f), B the rows 0..i of H[g] (log of factor (g+1) mod p)
and every row of Z[g] (its own log) along their columns.  Step k of a line
maps its entries (x0, x1, x2) at positions k..k+2 to

    o_j = (x0 F[j] + x1 F[3+j]) + x2 F[6+j],   j = 0, 1, 2

(B0 applies F^T to rows, B applies F to columns: the same products), writes
o0 at k and carries (o1, o2).  B0 keeps column m-1 of factor 0 unchanged at
step m (the window-boundary subdiagonal); B then writes the structural
zeros of H's rows m+1..i exactly.  Two schedules of this arithmetic are
modelled here, in float64 numpy with one rounding per operation (the host
stub of scripts/cuda_host_stub rounds the same way):

* ``replay_parent``: the design before this one, one line at a time (all
  lines of a target at once, as numpy vectors), bulge-major: bulge 0 walks
  the whole window, then bulge 1 walks it again, and so on.
* ``apply_model``: the kernels' schedule.  Lines go in tiles (one thread
  each), positions in chunks of ``chunk``, each chunk staged with the log
  rows its ticks read; all NB logs run in one pass, bulge b ``skew`` steps
  behind bulge b-1 (at tick t bulge b takes step k = t - skew b).  Each
  bulge reads position k+2 from the tile and writes position k back, so
  with skew 2 it reads exactly what bulge b-1 finished at the same tick
  (the kernels hand that entry over in a register); with skew 1 it reads
  an entry bulge b-1 still holds, and the result differs.  A chunk stays
  live until the next chunk's ticks have finished it (chunk >= skew NB),
  then goes back to the stack; reading or writing a chunk that is not
  live, or a log row that was not staged, fails.

At skew 2 every entry sees the same operations in the same order in both
schedules, so they agree bit for bit.
"""
import numpy as np


def dot3(x0, x1, x2, f0, f1, f2):
    """The kernels' __fma_rn(x2, f2, __fma_rn(x0, f0, __dmul_rn(x1, f1)))
    with each operation rounded on its own."""
    return (x0 * f0 + x1 * f1) + x2 * f2


def _step(F, x0, x1, x2):
    return (dot3(x0, x1, x2, F[0], F[3], F[6]), dot3(x0, x1, x2, F[1], F[4], F[7]),
            dot3(x0, x1, x2, F[2], F[5], F[8]))


def _logs(R, p, N):
    return np.asarray(R).reshape(-1, p, N, 9)


def _zero_mask(g, m):
    """H[g]'s structural zeros right of column m-1: rows r > m, columns
    below the subdiagonal (g == 0) or the diagonal."""
    return lambda r, q: (r > m) & (q < (r - 1 if g == 0 else r))


# ---------------------------------------------------------------- parent

def _walk_parent(X, logs, lines, m, i, keep=None):
    """Bulge-major walks of ``lines`` of the view X (lines x positions);
    logs: (nb, N, 9); keep: the line whose step m is the identity."""
    for F in logs:
        x0, x1 = X[lines, m].copy(), X[lines, m + 1].copy()
        for k in range(m, i):
            x2 = X[lines, k + 2].copy()
            o0, o1, o2 = _step(F[k], x0, x1, x2)
            if keep is not None and k == m:
                sel = lines == keep
                o0, o1, o2 = (np.where(sel, x0, o0), np.where(sel, x1, o1),
                              np.where(sel, x2, o2))
            X[lines, k] = o0
            x0, x1 = o1, o2
        X[lines, i] = x0
        X[lines, i + 1] = x1


def replay_left(H, R, m, i, nb):
    """The parent's B0 alone on a copy of H; R as for ``replay_parent``."""
    H = np.array(H, dtype=np.float64)
    p, N, _ = H.shape
    L = _logs(R, p, N)[:nb]
    c0 = max(m - 1, 0)
    for f in range(p):
        _walk_parent(H[f].T, L[:, f], np.arange(c0, N), m, i,
                     keep=m - 1 if f == 0 and m >= 1 else None)
    return H


def replay_parent(H, Z, R, m, i, nb):
    """The parent's B0 then B on copies of H and Z (Z may be None); R:
    (NB, p, N, 9) or (p, N, 9), the first nb bulges' logs are applied."""
    H = replay_left(H, R, m, i, nb)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, N, _ = H.shape
    L = _logs(R, p, N)[:nb]
    c0 = max(m - 1, 0)
    for g in range(p):
        _walk_parent(H[g], L[:, (g + 1) % p], np.arange(i + 1), m, i)
        if Z is not None:
            _walk_parent(Z[g], L[:, g], np.arange(N), m, i)
    for r in range(m + 1, i + 1):
        H[0, r, c0:r - 1] = 0.0
        H[1:, r, m:r] = 0.0
    return H, Z


# ---------------------------------------------------------------- kernels

class _Tile:
    """One block's lines: the live chunks of positions and the staged log
    rows of the chunk in use."""

    def __init__(self, X, lines, m, i, chunk):
        self.X, self.lines, self.m, self.i, self.W = X, lines, m, i, chunk
        self.live = {}
        self.staged = {}

    def _slot(self, q):
        j = (q - self.m) // self.W
        assert j in self.live, f"position {q} outside the live chunks {sorted(self.live)}"
        return self.live[j], q - self.m - j * self.W

    def get(self, q):
        buf, c = self._slot(q)
        return buf[:, c].copy()

    def put(self, q, v):
        buf, c = self._slot(q)
        buf[:, c] = v

    def load(self, j):
        q0 = self.m + j * self.W
        w = min(self.W, self.i + 2 - q0)
        buf = np.full((len(self.lines), self.W), np.nan)
        buf[:, :w] = self.X[self.lines, q0:q0 + w]
        self.live[j] = buf

    def write_back(self, j, zero):
        q0 = self.m + j * self.W
        w = min(self.W, self.i + 2 - q0)
        buf = self.live.pop(j)[:, :w]
        if zero is not None:
            q = np.arange(q0, q0 + w)
            buf = np.where(zero(self.lines[:, None], q[None, :]), 0.0, buf)
        assert not np.isnan(buf).any(), "a position of the span was never finished"
        self.X[self.lines, q0:q0 + w] = buf


def _walk_tile(X, logs, lines, m, i, chunk, skew, keep, zero):
    nb = len(logs)
    assert chunk >= skew * nb, "a chunk must be finished by the next chunk's ticks"
    tile = _Tile(X, lines, m, i, chunk)
    S = i + 2 - m
    nch = -(-S // chunk)
    x0, x1 = [None] * nb, [None] * nb
    for j in range(nch):
        tile.load(j)
        q0 = m + j * chunk
        w = min(chunk, S - j * chunk)
        # the log rows the chunk's ticks read: bulge b's steps q0-2-skew b
        # onwards, chunk + skew nb of them, those in m..i-1 only
        tile.staged = {(b, k): logs[b, k] for b in range(nb)
                       for k in range(q0 - 2 - skew * b, q0 - 2 - skew * b + chunk + skew * nb)
                       if m <= k < i}
        tend = q0 + w - 2 if j < nch - 1 else i + skew * (nb - 1) + 1
        for t in range(q0 - 2, tend):
            for b in range(nb):
                k = t - skew * b
                if k == m:
                    x0[b], x1[b] = tile.get(m), tile.get(m + 1)
                if m <= k < i:
                    x2 = tile.get(k + 2)
                    o0, o1, o2 = _step(tile.staged[b, k], x0[b], x1[b], x2)
                    if keep is not None and k == m:
                        sel = lines == keep
                        o0, o1, o2 = (np.where(sel, x0[b], o0), np.where(sel, x1[b], o1),
                                      np.where(sel, x2, o2))
                    tile.put(k, o0)
                    x0[b], x1[b] = o1, o2
                elif k == i:
                    tile.put(i, x0[b])
                    tile.put(i + 1, x1[b])
        if j >= 1:
            tile.write_back(j - 1, zero)
        if j == nch - 1:
            tile.write_back(j, zero)


def _walk_tiled(X, logs, first, count, m, i, tile, chunk, skew, keep=None, zero=None):
    for l0 in range(first, first + count, tile):
        lines = np.arange(l0, min(l0 + tile, first + count))
        _walk_tile(X, logs, lines, m, i, chunk, skew, keep, zero)


def apply_model(H, Z, R, m, i, nb, *, cols=32, rows=32, chunk=16, skew=2):
    """The kernels' schedule, B0 then B, on copies of H and Z (Z may be
    None).  cols: B0's columns per block; rows: B's rows per block; chunk:
    positions per chunk; skew: steps between consecutive bulges."""
    H = np.array(H, dtype=np.float64)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, N, _ = H.shape
    L = _logs(R, p, N)[:nb]
    c0 = max(m - 1, 0)
    for f in range(p):
        _walk_tiled(H[f].T, L[:, f], c0, N - c0, m, i, cols, chunk, skew,
                    keep=m - 1 if f == 0 and m >= 1 else None)
    for g in range(p):
        _walk_tiled(H[g], L[:, (g + 1) % p], 0, i + 1, m, i, rows, chunk, skew,
                    zero=_zero_mask(g, m))
        if g == 0 and m >= 1:
            H[0, m + 1:i + 1, m - 1] = 0.0  # column m-1 below the subdiagonal
        if Z is not None:
            _walk_tiled(Z[g], L[:, g], 0, N, m, i, rows, chunk, skew)
    return H, Z


def random_logs(rng, nb, p, N, m, i):
    """nb bulges' logs (nb, p, N, 9) of random orthogonal 3x3 transforms at
    the steps m..i-1, NaN elsewhere (a read outside the steps shows)."""
    q, _ = np.linalg.qr(rng.standard_normal((nb, p, i - m, 3, 3)))
    R = np.full((nb, p, N, 9), np.nan)
    R[:, :, m:i] = q.reshape(nb, p, i - m, 9)
    return R
