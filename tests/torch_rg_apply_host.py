"""JAX-free numpy model of the real generalized apply kernels rg B0 and rg B
(csrc/sweep_rg.cu).

B0 (``rg_sweep_left``) and B (``rg_sweep_right``) apply the chase log
(p, n, 28) of one double-shift sweep over the window [m, i] to the (p, n,
n) float64 stacks H and Z.  Both walk *lines* along the *positions* m..i:
B0 the columns >= m-1 of every H[f] down their rows (L, log entries 0..8
of factor f), B the rows 0..i of H[g] (R, entries 9..17 of factor g) and
every row of Z[g] (ZR, entries 18..26) along their columns.  Step j = m..i-2
of a line maps its entries (x0, x1, x2) at positions j..j+2 by the
row-major 3x3 M of step j,

    B0:  y_r = (M[3r] x0 + M[3r+1] x1) + M[3r+2] x2     (M x)
    B:   y_c = (x0 M[c] + x1 M[3+c]) + x2 M[6+c]        (x M)

writes y0 at j and carries (y1, y2) to step j+1; after step i-2 the
carried pair is positions i-1, i.  B then writes the structural zeros of
H's rows r = m..i exactly, from column m-1: in H[0] left of r-1 (row i:
left of i-2, keeping the closing bulge H[0][i, i-2]), in H[g>0] left of r;
and the regenerated H[0][r, r-1] = log[0, r, 27] for r <= i-2.

Each sum is written in the kernels as __fma_rn(x2, f2, __fma_rn(x0, f0,
__dmul_rn(x1, f1))), the order nvcc contracted the parent's; here (as on
the host stub of scripts/cuda_host_stub) every operation is rounded on its
own.  Two schedules of this arithmetic are modelled:

* ``replay_parent``: the design before this one, one thread per line
  walking all steps (all lines of a target at once, as numpy vectors).
* ``apply_model``: the kernels' schedule.  Lines go in tiles (one walking
  lane each), positions in chunks (``left_chunk`` for B0, ``chunk`` for B)
  staged in a ring of ``ahead + 1`` (B0) or ``ahead + 2`` (B) slots,
  ``ahead`` chunks ahead of the one in use, each chunk with the log
  entries of its steps q0-2..q0+w-3.  B0 stores its outputs straight to
  the stack and releases a chunk once walked; B writes its outputs into
  the slots and writes a chunk back, with the zeros and the logged r in
  place, once the next chunk's first two steps have finished it, and
  column m-1 after the ring.  Reading or writing a chunk that is not live,
  loading a chunk into a slot that is still held, or reading a log entry
  that was not staged fails.

Both schedules give every entry the same operations in the same order, so
they agree bit for bit.
"""
import numpy as np

LOG = 28  # float64 entries per (factor, step) of a chase log


def dot3(x0, x1, x2, f0, f1, f2):
    """The kernels' __fma_rn(x2, f2, __fma_rn(x0, f0, __dmul_rn(x1, f1)))
    with each operation rounded on its own."""
    return (x0 * f0 + x1 * f1) + x2 * f2


def left_step(M, x0, x1, x2):
    """M (x0, x1, x2)^T for a row-major M, (9,) or (9, lines)."""
    return tuple(dot3(x0, x1, x2, M[3 * r], M[3 * r + 1], M[3 * r + 2]) for r in range(3))


def right_step(M, x0, x1, x2):
    """(x0, x1, x2) M."""
    return tuple(dot3(x0, x1, x2, M[c], M[3 + c], M[6 + c]) for c in range(3))


def fix_rows(g, m, i, sub):
    """B's exact entries of H[g] at rows r, columns c (broadcast), given the
    walked values buf: the structural zeros of rows m..i from column m-1
    and H[0]'s regenerated subdiagonal sub[r] (r <= i-2)."""
    def fix(r, c, buf):
        r, c = r[:, None], c[None, :]
        win = r >= m
        if g > 0:
            return np.where(win & (c < r), 0.0, buf)
        out = np.where(win & (c < np.where(r < i, r - 1, i - 2)), 0.0, buf)
        return np.where(win & (r <= i - 2) & (c == r - 1), sub[r], out)
    return fix


# ---------------------------------------------------------------- parent

def _walk_parent(X, log, at, lines, m, i, step):
    """One thread per line of the view X (lines x positions): all steps."""
    x0, x1 = X[lines, m].copy(), X[lines, m + 1].copy()
    for k in range(m, i - 1):
        y0, x0, x1 = step(log[k, at:at + 9, None], x0, x1, X[lines, k + 2].copy())
        X[lines, k] = y0
    X[lines, i - 1] = x0
    X[lines, i] = x1


def replay_left(H, log, m, i):
    """The parent's B0 alone on a copy of H; log: (p, n, 28)."""
    H = np.array(H, dtype=np.float64)
    p, n, _ = H.shape
    for f in range(p):
        _walk_parent(H[f].T, log[f], 0, np.arange(m - 1, n), m, i, left_step)
    return H


def replay_parent(H, Z, log, m, i):
    """The parent's B0 then B on copies of H and Z (Z may be None)."""
    H = replay_left(H, log, m, i)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, n, _ = H.shape
    for g in range(p):
        _walk_parent(H[g], log[g], 9, np.arange(i + 1), m, i, right_step)
        if Z is not None:
            _walk_parent(Z[g], log[g], 18, np.arange(n), m, i, right_step)
    for r in range(m, i + 1):
        H[0, r, m - 1:(r - 1 if r < i else i - 2)] = 0.0
        if r <= i - 2:
            H[0, r, r - 1] = log[0, r, 27]
        H[1:, r, m - 1:r] = 0.0
    return H, Z


# ---------------------------------------------------------------- kernels

def staged_steps(q0, w, m, i):
    """The steps whose log entries chunk (q0, w) stages: q0-2..q0+w-3, those
    in m..i-2 only."""
    return [k for k in range(q0 - 2, q0 + w - 2) if m <= k <= i - 2]


class _Ring:
    """One block's slots of chunks (lines x chunk positions each)."""

    def __init__(self, X, lines, m, i, chunk, slots):
        self.X, self.lines, self.m, self.i, self.W = X, lines, m, i, chunk
        self.slots = slots
        self.live = {}  # chunk -> its buffer

    def span(self, j):
        q0 = self.m + j * self.W
        return q0, min(self.W, self.i + 1 - q0)

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
        held = [k for k in self.live if k % self.slots == j % self.slots]
        assert not held, f"chunk {j} copied into the slot of live chunk {held[0]}"
        q0, w = self.span(j)
        buf = np.full((len(self.lines), self.W), np.nan)
        buf[:, :w] = self.X[self.lines, q0:q0 + w]
        self.live[j] = buf

    def release(self, j):
        del self.live[j]

    def write_back(self, j, fix):
        q0, w = self.span(j)
        buf = self.live.pop(j)[:, :w]
        if fix is not None:
            buf = fix(self.lines, np.arange(q0, q0 + w), buf)
        assert not np.isnan(buf).any(), "a position of the span was never finished"
        self.X[self.lines, q0:q0 + w] = buf


def _walk_tile(X, log, at, lines, m, i, chunk, ahead, left, fix, stage, slots):
    step = left_step if left else right_step
    ring = _Ring(X, lines, m, i, chunk, slots)
    nch = -(-(i + 1 - m) // chunk)
    staged = {}

    def load(j):
        ring.load(j)
        staged[j] = {k: log[k, at:at + 9, None] for k in stage(*ring.span(j), m, i)}
    for j in range(min(ahead, nch)):
        load(j)
    x0 = x1 = None
    for j in range(nch):
        if j + ahead < nch:
            load(j + ahead)
        q0, w = ring.span(j)
        Ls = staged.pop(j)
        lo = q0
        if j == 0:
            x0, x1 = ring.get(m), ring.get(m + 1)
            lo = m + 2
        for q in range(lo, q0 + w):  # step k = q-2 reads position q as x2
            k = q - 2
            assert k in Ls, f"step {k}'s log entries were not staged with chunk {j}"
            y0, x0, x1 = step(Ls[k], x0, x1, ring.get(q))
            if left:
                X[lines, k] = y0
            else:
                ring.put(k, y0)
        if j == nch - 1:
            if left:
                X[lines, i - 1], X[lines, i] = x0, x1
            else:
                ring.put(i - 1, x0)
                ring.put(i, x1)
        if left:
            ring.release(j)
        else:
            if j >= 1:
                ring.write_back(j - 1, fix)
            if j == nch - 1:
                ring.write_back(j, fix)


def model_left(H, log, m, i, *, cols=16, chunk=64, ahead=2, stage=staged_steps):
    """The kernels' B0 alone on a copy of H (sizes as ``apply_model``)."""
    H = np.array(H, dtype=np.float64)
    log = np.asarray(log)
    p, n, _ = H.shape
    for f in range(p):
        for c0 in range(m - 1, n, cols):
            _walk_tile(H[f].T, log[f], 0, np.arange(c0, min(c0 + cols, n)), m, i, chunk,
                       ahead, True, None, stage, ahead + 1)
    return H


def apply_model(H, Z, log, m, i, *, cols=16, rows=16, chunk=32, left_chunk=64, ahead=2,
                stage=staged_steps, right_slots=None):
    """The kernels' schedule, B0 then B, on copies of H and Z (Z may be
    None).  cols: B0's columns per block; rows: B's rows per block; chunk:
    B's positions per chunk; left_chunk: B0's; ahead: chunks in flight
    ahead of the one in use; stage: the steps a chunk stages
    (``staged_steps``); right_slots: B's ring slots (ahead + 2).  The
    defaults are the kernels' sizes."""
    log = np.asarray(log)
    H = model_left(H, log, m, i, cols=cols, chunk=left_chunk, ahead=ahead, stage=stage)
    Z = None if Z is None else np.array(Z, dtype=np.float64)
    p, n, _ = H.shape
    rslots = ahead + 2 if right_slots is None else right_slots
    sub = log[0, :, 27]
    for g in range(p):
        fix = fix_rows(g, m, i, sub)
        for r0 in range(0, i + 1, rows):
            lines = np.arange(r0, min(r0 + rows, i + 1))
            _walk_tile(H[g], log[g], 9, lines, m, i, chunk, ahead, False, fix, stage, rslots)
            # column m-1 of the tile's rows m..i, after the ring
            H[g, lines, m - 1:m] = fix(lines, np.array([m - 1]), H[g, lines, m - 1:m])
        if Z is not None:
            for r0 in range(0, n, rows):
                _walk_tile(Z[g], log[g], 18, np.arange(r0, min(r0 + rows, n)), m, i, chunk,
                           ahead, False, None, stage, rslots)
    return H, Z


def random_log(rng, p, n, m, i):
    """A (p, n, 28) log of random orthogonal 3x3 L, R and ZR at the steps
    m..i-2 and random regenerated entries r of factor 0, NaN elsewhere (a
    read outside the steps shows)."""
    def orth(*shape):
        return np.linalg.qr(rng.standard_normal((*shape, 3, 3)))[0].reshape(*shape, 9)
    log = np.full((p, n, LOG), np.nan)
    K = i - 1 - m
    for at in (0, 9, 18):
        log[:, m:i - 1, at:at + 9] = orth(p, K)
    log[:, m:i - 1, 27] = 0.0
    log[0, m:i - 1, 27] = rng.standard_normal(K)
    return log
