"""JAX-free numpy model of the complex apply kernels B0 and B (csrc/sweep_cx.cu).

B0 (``qz_sweep_left``) and B (``qz_sweep_right``) apply the rotation log
(p, n, 16) of a single-shift complex QZ sweep over the window [m, i] to the
(p, n, n) complex128 stacks H and Z.  Both walk *lines* along the
*positions* m..i: B0 the columns >= m of every H[f] down their rows (L, log
entries 0..3 of factor f), B the rows 0..i of H[g] (R, entries 4..7 of
factor g) and every row of Z[g] (ZR, entries 8..11) along their columns.
Step k of a line maps its entries (x0, x1) at positions k, k+1 by the
row-major 2x2 M of step k,

    B0:  (y0, y1) = (M0 x0 + M1 x1, M2 x0 + M3 x1)
    B:   (y0, y1) = (x0 M0 + x1 M2, x0 M1 + x1 M3)

writes y0 at k and carries y1 to step k+1; after step i-1 the carried
entry is position i.  Column m-1 of H[0] is never touched.  B then writes
the structural zeros of H's rows m+1..i exactly and the logged subdiagonal
H[0][r, r-1] = log[0, r, 12] for m < r < i.

Each complex product a b is (a.re b.re - a.im b.im, a.re b.im + a.im b.re)
and each sum a plain sum of the parts, every operation rounded on its own:
the tree of the kernels' __fma_rn/__dmul_rn/__dadd_rn (the parent's SASS
fuses the first product of each part; the host stub of
scripts/cuda_host_stub rounds each operation on its own, as numpy does).
Two schedules of this arithmetic are modelled:

* ``replay_parent``: the design before this one, one thread per line
  walking all steps (all lines of a target at once, as numpy vectors).
* ``apply_model``: the kernels' schedule.  Lines go in tiles (one walking
  lane each), positions in chunks (``left_chunk`` for B0, ``chunk`` for B)
  staged in a ring of
  ``ahead + 1`` (B0) or ``ahead + 2`` (B) slots, ``ahead`` chunks ahead of
  the one in use, each chunk with the log entries of its steps
  q0-1..q0+w-2.  B0 stores its outputs straight to the stack and releases
  a chunk once walked; B writes its outputs into the slots and writes a
  chunk back once the next chunk's first step has finished it.  Reading or
  writing a chunk that is not live, loading a chunk into a slot that is
  still held, or reading a log entry that was not staged fails.

Both schedules give every entry the same operations in the same order, so
they agree bit for bit.
"""
import numpy as np

LOG = 16  # complex128 entries per (factor, step) of a sweep log


def _cx(re, im):
    out = np.empty(np.broadcast(re, im).shape, np.complex128)
    out.real, out.imag = re, im
    return out


def cmul(a, b):
    """a b of two complex arrays, each part's two products and their sum
    rounded on their own."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return _cx(ar * br - ai * bi, ar * bi + ai * br)


def cadd(a, b):
    return _cx(a.real + b.real, a.imag + b.imag)


def left_step(M, x0, x1):
    """(y0, y1) = M (x0, x1)^T, M (4,) or (4, lines) row-major."""
    return cadd(cmul(M[0], x0), cmul(M[1], x1)), cadd(cmul(M[2], x0), cmul(M[3], x1))


def right_step(M, x0, x1):
    """(y0, y1) = (x0, x1) M."""
    return cadd(cmul(x0, M[0]), cmul(x1, M[2])), cadd(cmul(x0, M[1]), cmul(x1, M[3]))


# ---------------------------------------------------------------- parent

def _walk_parent(X, log, at, lines, m, i, step):
    """One thread per line of the view X (lines x positions): all steps."""
    x0 = X[lines, m].copy()
    for k in range(m, i):
        y0, x0 = step(log[k, at:at + 4, None], x0, X[lines, k + 1].copy())
        X[lines, k] = y0
    X[lines, i] = x0


def replay_left(H, log, m, i):
    """The parent's B0 alone on a copy of H; log: (p, n, 16)."""
    H = np.array(H, dtype=np.complex128)
    p, n, _ = H.shape
    for f in range(p):
        _walk_parent(H[f].T, log[f], 0, np.arange(m, n), m, i, left_step)
    return H


def replay_parent(H, Z, log, m, i):
    """The parent's B0 then B on copies of H and Z (Z may be None)."""
    H = replay_left(H, log, m, i)
    Z = None if Z is None else np.array(Z, dtype=np.complex128)
    p, n, _ = H.shape
    for g in range(p):
        _walk_parent(H[g], log[g], 4, np.arange(i + 1), m, i, right_step)
        if Z is not None:
            _walk_parent(Z[g], log[g], 8, np.arange(n), m, i, right_step)
    for r in range(m + 1, i + 1):
        H[0, r, m:r - 1] = 0.0
        if r < i:
            H[0, r, r - 1] = log[0, r, 12]
        H[1:, r, m:r] = 0.0
    return H, Z


# ---------------------------------------------------------------- kernels

def staged_steps(q0, w, m, i):
    """The steps whose log entries chunk (q0, w) stages: q0-1..q0+w-2, those
    in m..i-1 only."""
    return [k for k in range(q0 - 1, q0 + w - 1) if m <= k < i]


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
        buf = np.full((len(self.lines), self.W), np.nan + 0j)
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
    for j in range(min(ahead, nch)):
        ring.load(j)
        staged[j] = {k: log[k, at:at + 4, None] for k in stage(*ring.span(j), m, i)}
    x0 = None
    for j in range(nch):
        if j + ahead < nch:
            ring.load(j + ahead)
            staged[j + ahead] = {k: log[k, at:at + 4, None]
                                 for k in stage(*ring.span(j + ahead), m, i)}
        q0, w = ring.span(j)
        Ls = staged.pop(j)
        if j == 0:
            x0 = ring.get(m)
        for k in range(max(q0 - 1, m), q0 + w - 1):
            assert k in Ls, f"step {k}'s log entries were not staged with chunk {j}"
            y0, x0 = step(Ls[k], x0, ring.get(k + 1))
            if left:
                X[lines, k] = y0
            else:
                ring.put(k, y0)
        if j == nch - 1:
            if left:
                X[lines, i] = x0
            else:
                ring.put(i, x0)
        if left:
            ring.release(j)
        else:
            if j >= 1:
                ring.write_back(j - 1, fix)
            if j == nch - 1:
                ring.write_back(j, fix)


def model_left(H, log, m, i, *, cols=16, chunk=32, ahead=2, stage=staged_steps):
    """The kernels' B0 alone on a copy of H (sizes as ``apply_model``)."""
    H = np.array(H, dtype=np.complex128)
    log = np.asarray(log)
    p, n, _ = H.shape
    for f in range(p):
        for c0 in range(m, n, cols):
            _walk_tile(H[f].T, log[f], 0, np.arange(c0, min(c0 + cols, n)), m, i, chunk,
                       ahead, True, None, stage, ahead + 1)
    return H


def apply_model(H, Z, log, m, i, *, cols=16, rows=16, chunk=24, left_chunk=32, ahead=2,
                stage=staged_steps, right_slots=None):
    """The kernels' schedule, B0 then B, on copies of H and Z (Z may be
    None).  cols: B0's columns per block; rows: B's rows per block; chunk:
    B's positions per chunk; left_chunk: B0's; ahead: chunks in flight
    ahead of the one in use; stage: the steps a chunk stages
    (``staged_steps``); right_slots: B's ring slots (ahead + 2).  The
    defaults are the kernels' sizes."""
    log = np.asarray(log)
    H = model_left(H, log, m, i, cols=cols, chunk=left_chunk, ahead=ahead, stage=stage)
    Z = None if Z is None else np.array(Z, dtype=np.complex128)
    p, n, _ = H.shape
    rslots = ahead + 2 if right_slots is None else right_slots
    sub = log[0, :, 12]
    for g in range(p):
        def fix(r, c, buf, g=g):
            r, c = r[:, None], c[None, :]
            out = np.where((r > m) & (c < (r - 1 if g == 0 else r)), 0.0, buf)
            if g == 0:
                out = np.where((r > m) & (r < i) & (c == r - 1), sub[r], out)
            return out
        for r0 in range(0, i + 1, rows):
            _walk_tile(H[g], log[g], 4, np.arange(r0, min(r0 + rows, i + 1)), m, i, chunk,
                       ahead, False, fix, stage, rslots)
        if Z is not None:
            for r0 in range(0, n, rows):
                _walk_tile(Z[g], log[g], 8, np.arange(r0, min(r0 + rows, n)), m, i, chunk,
                           ahead, False, None, stage, rslots)
    return H, Z


def random_log(rng, p, n, m, i):
    """A (p, n, 16) log of random unitary 2x2 L, R and ZR at the steps
    m..i-1 and random subdiagonal entries r, NaN elsewhere (a read outside
    the steps shows)."""
    def unitary(*shape):
        a = rng.standard_normal((*shape, 2, 2)) + 1j * rng.standard_normal((*shape, 2, 2))
        return np.linalg.qr(a)[0].reshape(*shape, 4)
    log = np.full((p, n, LOG), np.nan + 0j)
    K = i - m
    for at in (0, 4, 8):
        log[:, m:i, at:at + 4] = unitary(p, K)
    log[:, m:i, 12:] = 0.0
    log[0, m:i, 12] = rng.standard_normal(K) + 1j * rng.standard_normal(K)
    return log
