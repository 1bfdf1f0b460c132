"""Singular-triangular-factor deflation for the complex periodic QZ core
(port of ``ops/pqz_deflate.py``).

When a diagonal entry of a triangular factor is negligible, the zero is
exploited instead of a shifted sweep (reference src/generalized.jl):

* ``pos_core`` (DEFLATE_POS, :453-566): a direct factor; two unshifted
  half-sweeps meet at the zero;
* ``neg_core`` (DEFLATE_NEG, :568-740): an inverted factor; the zero is
  chased off the bottom or the top of the window;
* ``czshift_core`` (:356-448): the controlled zero shift.

All three act in place on the contiguous (p, n, n) stacks H and Z.

* A float64 or complex128 CUDA tensor launches the action's kernel of
  ``csrc/pqz_deflate.cu`` (the JAX package runs the actions in jnp inside
  its jitted cores, with no Pallas kernel): one launch of one block
  generates every rotation and applies every update on the card.
  ``pos_core`` and ``neg_core`` read nothing back; ``czshift_core`` reads
  one device int, the flag that its final chain holds an identity rotation.
  ``neg_core`` chooses the direction of its chase on the host, from
  integers.  Other dtypes on the card raise.
* A CPU tensor takes ``pos_core_plain``, ``neg_core_plain`` and
  ``czshift_core_plain``, the card-side reference too.  The JAX package
  runs its loops over all n steps with masks and switches over the factor
  kind; here the active ranges and the factor kinds are host integers, so
  the loops are Python loops over the active steps.  Each rotation is
  generated on the host from the entries it reads, fetched in one transfer
  (``givens_host``, the same operations as the JAX ``givens``), which also
  decides the controlled zero shift's data-dependent masks; the 2x2
  updates run as torch products.

Indices are clamped exactly as the JAX package's ``getel``/``rowsk`` clamp
them, in both versions.  ``launches`` counts the kernels' launches (one per
action on the card, either instance), as the C entry points report them.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _cuda
from .rotations import (colsk, givens_at, givens_host, lmat_host, rmat_adj_host,
                        rowsk, setel)
from .sweep_cx import _signature

launches = {"deflate_czshift": 0, "deflate_pos": 0, "deflate_neg": 0}


def _lmat(H, c, s):
    return torch.tensor(lmat_host(c, s), dtype=H.dtype, device=H.device)


def _rmat_adj(H, c, s):
    return torch.tensor(rmat_adj_host(c, s), dtype=H.dtype, device=H.device)


def _bottom(jlo, jdef, ilast):
    """DEFLATE_NEG chases the zero off the bottom of the window when it lies
    past the window's middle, else off the top."""
    return float(jdef + 1) > float(ilast - jlo + 1) / 2


def _on_card(H, what):
    """True for a float64 / complex128 CUDA tensor, False for a CPU one."""
    if H.device.type == "cpu":
        return False
    if H.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {H.device}")
    if H.dtype not in (torch.float64, torch.complex128):
        raise ValueError(f"{what}: H on the card must be float64 or complex128, "
                         f"got {H.dtype}")
    if not H.is_contiguous():
        raise ValueError(f"{what}: H must be contiguous (the action is in place)")
    return True


class DeflateCores:
    """The three deflation actions for one (p, S) problem."""

    def __init__(self, p: int, S: Sequence[bool], want_z: bool,
                 ulp: float, smlnum: float):
        self.p, self.S = p, tuple(bool(x) for x in S)
        self.want_z, self.ulp, self.smlnum = want_z, ulp, smlnum

    # ------------------------------------------------------------------
    # the routes: the kernel on the card, the plain version on the CPU
    def pos_core(self, H, Z, jlo: int, ldef: int, jdef: int, ilast: int):
        """Zero diagonal H[ldef][jdef, jdef] of a direct factor; (H, Z)."""
        if not _on_card(H, "pos_core"):
            return self.pos_core_plain(H, Z, jlo, ldef, jdef, ilast)
        self._launch("pos", H, Z, (jlo, ldef, jdef, ilast))
        return H, Z

    def neg_core(self, H, Z, jlo: int, ldef: int, jdef: int, ilast: int):
        """Zero diagonal H[ldef][jdef, jdef] of an inverted factor; (H, Z)."""
        if not _on_card(H, "neg_core"):
            return self.neg_core_plain(H, Z, jlo, ldef, jdef, ilast)
        self._launch("neg", H, Z, (jlo, ldef, jdef, ilast,
                                   int(_bottom(jlo, jdef, ilast))))
        return H, Z

    def czshift_core(self, H, Z, jlo: int, ilast: int):
        """Controlled zero shift on the window [jlo, ilast]; (H, Z, zflag),
        zflag True when a rotation of the final chain is the identity."""
        if not _on_card(H, "czshift_core"):
            return self.czshift_core_plain(H, Z, jlo, ilast)
        zflag = torch.zeros(1, dtype=torch.int32, device=H.device)
        self._launch("czshift", H, Z, (jlo, ilast, self.ulp, self.smlnum), zflag)
        return H, Z, bool(zflag.item())

    def _launch(self, action, H, Z, args, zflag=None):
        """One launch of ``psd_deflate_<action>`` on H's card.  Z goes to the
        kernel transposed (its column updates become row updates, whose
        loads coalesce) and comes back in place."""
        p, n, _ = H.shape
        if self.want_z and (Z is None or Z.dtype != H.dtype or Z.device != H.device):
            raise ValueError(f"{action}: Z must be a {H.dtype} tensor on {H.device}")
        lib = _cuda.load()
        cx = H.is_complex()
        ZT = Z.transpose(1, 2).contiguous() if self.want_z else None
        ptrs = [H.data_ptr(), None if ZT is None else ZT.data_ptr(),
                _signature(self.S, H.device).data_ptr()]
        if action != "neg":
            ws = torch.empty(lib.psd_deflate_scratch(n, int(cx)), dtype=torch.uint8,
                             device=H.device)
            ptrs.append(ws.data_ptr())
        if zflag is not None:
            ptrs.append(zflag.data_ptr())
        entry = getattr(lib, f"psd_deflate_{action}" + ("_c128" if cx else ""))
        nlaunch = ctypes.c_int(0)
        with _cuda.on_device(H):
            rc = entry(*ptrs, p, n, *args, ctypes.byref(nlaunch), _cuda.stream_ptr(H))
        launches[f"deflate_{action}"] += nlaunch.value
        _cuda.check(rc, f"deflate_{action}")
        if ZT is not None:
            Z.copy_(ZT.transpose(1, 2))

    # ------------------------------------------------------------------
    # the plain versions

    def _zup(self, Z, l, base, c, s):
        """Z[l] <- Z[l] G(base, base+1, c, s)'."""
        if self.want_z:
            colsk(Z[l], base, _rmat_adj(Z[l], c, s))

    def _chain_right(self, M, G, ks):
        for k in ks:
            colsk(M, k, _rmat_adj(M, *G[k]))

    # ------------------------------------------------------------------
    def pos_core_plain(self, H, Z, jlo: int, ldef: int, jdef: int, ilast: int):
        """Zero diagonal H[ldef][jdef, jdef] of a direct factor."""
        p, S, z = self.p, self.S, 0.0
        setel(H[ldef], jdef, jdef, z)

        # ---- first unshifted half-sweep (downwards from jlo) -----------
        G = {}
        H0 = H[0]
        for k in range(jlo, jdef):
            c, s, r = givens_at(H0, k, k, k + 1, k)
            setel(H0, k, k, r)
            setel(H0, k + 1, k, z)
            rowsk(H0, k, _lmat(H0, c, s), lo=k + 1)
            G[k] = (c, s)
        if self.want_z:
            self._chain_right(Z[0], G, range(jlo, jdef))
        for l in range(p - 1, 0, -1):
            ntra = jdef - 2 if l < ldef else jdef - 1
            Hl = H[l]
            for k in range(jlo, ntra + 1):
                if S[l]:
                    colsk(Hl, k, _rmat_adj(Hl, *G[k]), hi=k + 2)
                    c, s, r = givens_at(Hl, k, k, k + 1, k)
                    setel(Hl, k, k, r)
                    setel(Hl, k + 1, k, z)
                    rowsk(Hl, k, _lmat(Hl, c, s), lo=k + 1)
                    G[k] = (c, s)
                else:
                    rowsk(Hl, k, _lmat(Hl, *G[k]), lo=k)
                    c, s, r = givens_at(Hl, k + 1, k + 1, k + 1, k)
                    setel(Hl, k + 1, k + 1, r)
                    setel(Hl, k + 1, k, z)
                    colsk(Hl, k, _lmat(Hl, c, s), hi=k + 1)
                    G[k] = (c, -s)
            if self.want_z:
                self._chain_right(Z[l], G, range(jlo, ntra + 1))
        for k in range(jlo, jdef - 1):
            colsk(H0, k, _rmat_adj(H0, *G[k]), hi=k + 2)

        # ---- second unshifted half-sweep (upwards from ilast) ----------
        G2 = {}
        for j in range(ilast, jdef, -1):
            c, s, r = givens_at(H0, j, j, j, j - 1)
            setel(H0, j, j, r)
            setel(H0, j, j - 1, z)
            colsk(H0, j - 1, _lmat(H0, c, s), hi=j)
            G2[j] = (c, -s)
        if self.want_z:
            self._chain_desc(Z[1 % p], G2, jdef + 1, ilast)
        for l in range(1, p):
            ntra = jdef + 2 if l > ldef else jdef + 1
            Hl = H[l]
            for j in range(ilast, ntra - 1, -1):
                if not S[l]:
                    colsk(Hl, j - 1, _rmat_adj(Hl, *G2[j]), hi=j + 1)
                    c, s, r = givens_at(Hl, j - 1, j - 1, j, j - 1)
                    setel(Hl, j - 1, j - 1, r)
                    setel(Hl, j, j - 1, z)
                    rowsk(Hl, j - 1, _lmat(Hl, c, s), lo=j)
                    G2[j] = (c, s)
                else:
                    rowsk(Hl, j - 1, _lmat(Hl, *G2[j]), lo=j - 1)
                    c, s, r = givens_at(Hl, j, j, j, j - 1)
                    setel(Hl, j, j, r)
                    setel(Hl, j, j - 1, z)
                    colsk(Hl, j - 1, _lmat(Hl, c, s), hi=j)
                    G2[j] = (c, -s)
            if self.want_z:
                self._chain_desc(Z[(l + 1) % p], G2, ntra, ilast)
        for j in range(ilast, jdef + 1, -1):
            rowsk(H0, j - 1, _lmat(H0, *G2[j]), lo=j - 1)
        return H, Z

    def _chain_desc(self, M, G, klo, khi):
        """M <- M * prod G(k-1, k)' for k = khi..klo descending."""
        for k in range(khi, klo - 1, -1):
            colsk(M, k - 1, _rmat_adj(M, *G[k]))

    # ------------------------------------------------------------------
    # ring-walk steps of DEFLATE_NEG; each returns (j, c, s)
    @staticmethod
    def _hess_dn(Hl, j, c, s):
        rowsk(Hl, j, _lmat(Hl, c, s), lo=j - 1)
        cn, sn, r = givens_at(Hl, j + 1, j, j + 1, j - 1)
        setel(Hl, j + 1, j, r)
        setel(Hl, j + 1, j - 1, 0.0)
        colsk(Hl, j - 1, _lmat(Hl, cn, sn), hi=j + 1)
        return j - 1, cn, -sn

    @staticmethod
    def _pos_dn(Hl, j, c, s):
        rowsk(Hl, j, _lmat(Hl, c, s), lo=j)
        cn, sn, r = givens_at(Hl, j + 1, j + 1, j + 1, j)
        setel(Hl, j + 1, j + 1, r)
        setel(Hl, j + 1, j, 0.0)
        colsk(Hl, j, _lmat(Hl, cn, sn), hi=j + 1)
        return j, cn, -sn

    @staticmethod
    def _neg_dn(Hl, j, c, s):
        colsk(Hl, j, _rmat_adj(Hl, c, s), hi=j + 2)
        cn, sn, r = givens_at(Hl, j, j, j + 1, j)
        setel(Hl, j, j, r)
        setel(Hl, j + 1, j, 0.0)
        rowsk(Hl, j, _lmat(Hl, cn, sn), lo=j + 1)
        return j, cn, sn

    @staticmethod
    def _hess_up(Hl, j, c, s):
        colsk(Hl, j - 1, _rmat_adj(Hl, c, s), hi=j + 2)
        cn, sn, r = givens_at(Hl, j, j - 1, j + 1, j - 1)
        setel(Hl, j, j - 1, r)
        setel(Hl, j + 1, j - 1, 0.0)
        rowsk(Hl, j, _lmat(Hl, cn, sn), lo=j)
        return j + 1, cn, sn

    @staticmethod
    def _neg_up(Hl, j, c, s):
        rowsk(Hl, j - 1, _lmat(Hl, c, s), lo=j - 1)
        cn, sn, r = givens_at(Hl, j, j, j, j - 1)
        setel(Hl, j, j, r)
        setel(Hl, j, j - 1, 0.0)
        colsk(Hl, j - 1, _lmat(Hl, cn, sn), hi=j)
        return j, cn, -sn

    @staticmethod
    def _pos_up(Hl, j, c, s):
        colsk(Hl, j - 1, _rmat_adj(Hl, c, s), hi=j + 1)
        cn, sn, r = givens_at(Hl, j - 1, j - 1, j, j - 1)
        setel(Hl, j - 1, j - 1, r)
        setel(Hl, j, j - 1, 0.0)
        rowsk(Hl, j - 1, _lmat(Hl, cn, sn), lo=j)
        return j, cn, sn

    def neg_core_plain(self, H, Z, jlo: int, ldef: int, jdef: int, ilast: int):
        """Zero diagonal H[ldef][jdef, jdef] of an inverted factor."""
        setel(H[ldef], jdef, jdef, 0.0)
        if _bottom(jlo, jdef, ilast):
            self._chase_down(H, Z, jlo, ldef, jdef, ilast)
        else:
            self._chase_up(H, Z, jlo, ldef, jdef, ilast)
        return H, Z

    def _chase_down(self, H, Z, jlo, ldef, jdef, ilast):
        p, S = self.p, self.S
        steps = {"h": self._hess_dn, "p": self._pos_dn, "n": self._neg_dn}
        for j1 in range(jdef, ilast):
            j = j1
            Hl = H[ldef]
            c, s, r = givens_at(Hl, j, j + 1, j + 1, j + 1)
            setel(Hl, j, j + 1, r)
            setel(Hl, j + 1, j + 1, 0.0)
            rowsk(Hl, j, _lmat(Hl, c, s), lo=j + 2)
            ln = (ldef + 1) % p
            self._zup(Z, ln, j, c, s)
            for _ in range(p - 1):
                kind = "h" if ln == 0 else ("p" if S[ln] else "n")
                j, c, s = steps[kind](H[ln], j, c, s)
                ln = (ln + 1) % p
                self._zup(Z, ln, j, c, s)
            colsk(H[ldef], j, _rmat_adj(H[ldef], c, s), hi=j + 1)

        # deflate the last element of the Hessenberg factor
        j = ilast
        H0 = H[0]
        c, s, r = givens_at(H0, j, j, j, j - 1)
        setel(H0, j, j, r)
        setel(H0, j, j - 1, 0.0)
        colsk(H0, j - 1, _lmat(H0, c, s), hi=j)
        c2, s2 = c, -s
        self._zup(Z, 1 % p, j - 1, c2, s2)
        for l in range(1, ldef):
            Hl = H[l]
            if not S[l]:
                colsk(Hl, j - 1, _rmat_adj(Hl, c2, s2), hi=j + 1)
                cn, sn, r = givens_at(Hl, j - 1, j - 1, j, j - 1)
                setel(Hl, j - 1, j - 1, r)
                setel(Hl, j, j - 1, 0.0)
                rowsk(Hl, j - 1, _lmat(Hl, cn, sn), lo=j)
                c2, s2 = cn, sn
            else:
                rowsk(Hl, j - 1, _lmat(Hl, c2, s2), lo=j - 1)
                cn, sn, r = givens_at(Hl, j, j, j, j - 1)
                setel(Hl, j, j, r)
                setel(Hl, j, j - 1, 0.0)
                colsk(Hl, j - 1, _lmat(Hl, cn, sn), hi=j)
                c2, s2 = cn, -sn
            self._zup(Z, (l + 1) % p, j - 1, c2, s2)
        colsk(H[ldef], j - 1, _rmat_adj(H[ldef], c2, s2), hi=j + 1)

    def _chase_up(self, H, Z, jlo, ldef, jdef, ilast):
        p, S = self.p, self.S
        steps = {"h": self._hess_up, "p": self._pos_up, "n": self._neg_up}
        for j1 in range(jdef, jlo, -1):
            j = j1
            Hl = H[ldef]
            c, s, r = givens_at(Hl, j - 1, j, j - 1, j - 1)
            setel(Hl, j - 1, j, r)
            setel(Hl, j - 1, j - 1, 0.0)
            colsk(Hl, j - 1, _lmat(Hl, c, s), hi=j - 1)
            s = -s
            self._zup(Z, ldef, j - 1, c, s)
            ln = (ldef - 1) % p
            for _ in range(p - 1):
                kind = "h" if ln == 0 else ("p" if S[ln] else "n")
                j, c, s = steps[kind](H[ln], j, c, s)
                self._zup(Z, ln, j - 1, c, s)
                ln = (ln - 1) % p
            rowsk(H[ldef], j - 1, _lmat(H[ldef], c, s), lo=j)

        # deflate the first element of the Hessenberg factor
        j = jlo
        H0 = H[0]
        c, s, r = givens_at(H0, j, j, j + 1, j)
        setel(H0, j, j, r)
        setel(H0, j + 1, j, 0.0)
        rowsk(H0, j, _lmat(H0, c, s), lo=j + 1)
        c2, s2 = c, s
        self._zup(Z, 0, j, c2, s2)
        for l in range(p - 1, ldef, -1):
            Hl = H[l]
            if S[l]:
                colsk(Hl, j, _rmat_adj(Hl, c2, s2), hi=j + 2)
                cn, sn, r = givens_at(Hl, j, j, j + 1, j)
                setel(Hl, j, j, r)
                setel(Hl, j + 1, j, 0.0)
                rowsk(Hl, j, _lmat(Hl, cn, sn), lo=j + 1)
                c2, s2 = cn, sn
            else:
                rowsk(Hl, j, _lmat(Hl, c2, s2), lo=j)
                cn, sn, r = givens_at(Hl, j + 1, j + 1, j + 1, j)
                setel(Hl, j + 1, j + 1, r)
                setel(Hl, j + 1, j, 0.0)
                colsk(Hl, j, _lmat(Hl, cn, sn), hi=j + 1)
                c2, s2 = cn, -sn
            self._zup(Z, l, j, c2, s2)
        rowsk(H[ldef], j, _lmat(H[ldef], c2, s2), lo=j + 1)

    # ------------------------------------------------------------------
    def czshift_core_plain(self, H, Z, jlo: int, ilast: int):
        """Controlled zero shift on the window [jlo, ilast].

        Returns (H, Z, zflag): zflag is True when a rotation of the final
        chain is the identity (a factor's entry was negligible)."""
        p, S = self.p, self.S
        ks = range(jlo, ilast)
        # stage A: triangularize the Hessenberg factor on [jlo, ilast]
        H0 = H[0]
        Gc, Gs = {}, {}
        for k in ks:
            c, s, r = givens_at(H0, k, k, k + 1, k)
            setel(H0, k, k, r)
            setel(H0, k + 1, k, 0.0)
            rowsk(H0, k, _lmat(H0, c, s), lo=k + 1)
            Gc[k], Gs[k] = c, s
        if self.want_z:
            for k in ks:
                colsk(Z[0], k, _rmat_adj(Z[0], Gc[k], Gs[k]))

        # stage B: propagate backwards through the triangular factors; a
        # rotation whose incoming s is exactly zero is skipped, and one whose
        # entry to annihilate is negligible becomes the identity
        for l in range(p - 1, 0, -1):
            Hl = H[l]
            for k in ks:
                if Gs[k] == 0:
                    continue
                if S[l]:
                    colsk(Hl, k, _rmat_adj(Hl, Gc[k], Gs[k]), hi=k + 2)
                else:
                    rowsk(Hl, k, _lmat(Hl, Gc[k], Gs[k]), lo=k)
                d0, d1, g = Hl[[k, k + 1, k + 1], [k, k + 1, k]].tolist()
                negl = abs(g) <= max(self.ulp * (abs(d0) + abs(d1)), self.smlnum)
                c, s, r = givens_host(d0 if S[l] else d1, g)
                if not negl:
                    setel(Hl, *((k, k) if S[l] else (k + 1, k + 1)), r)
                setel(Hl, k + 1, k, 0.0)
                if not negl:
                    if S[l]:
                        rowsk(Hl, k, _lmat(Hl, c, s), lo=k + 1)
                    else:
                        colsk(Hl, k, _lmat(Hl, c, s), hi=k + 1)
                Gc[k] = 1.0 if negl else c
                Gs[k] = 0.0 if negl else (s if S[l] else -s)
            if self.want_z:
                for k in ks:
                    colsk(Z[l], k, _rmat_adj(Z[l], Gc[k], Gs[k]))

        # stage C: apply the final chain to the right side of H[0]
        for k in ks:
            colsk(H0, k, _rmat_adj(H0, Gc[k], Gs[k]), hi=k + 2)
        return H, Z, any(Gs[k] == 0 for k in ks)
