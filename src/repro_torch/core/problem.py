"""Canonical-form LP/MILP containers — the port of ``repro/core/problem.py``.

Every allocation problem lowers to the canonical form

    minimize    c^T x
    subject to  G x <= h          (n_ineq rows)
                A x  = b          (n_eq rows)
                l <= x <= u       (box)

which the PDHG solver (``core/pdhg.py``) consumes stacked as
``K = [G; A]``, ``q = [h; b]``, with the first ``n_ineq`` duals projected
>= 0.  Problems are stored dense and 128-padded, and the padding is
self-neutralising exactly as in the reference:

  * padded variables get  l = u = 0, c = 0        (pinned to zero)
  * padded ineq rows get  G row = 0, h = +BIG     (trivially satisfied)
  * padded eq rows get    A row = 0, b = 0        (trivially satisfied)

:meth:`LinearProgram.build` pads in float64 numpy, verbatim the
reference's code, and only then converts, so the padded tensors are
exactly equal to the reference's arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

BIG = 1e9  # stand-in for +inf in padded rows / free bounds (f32-safe)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  With no CUDA device present the default raises — it
    never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the GPU "
                "by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class LinearProgram:
    """One canonical-form LP (or, after :func:`stack_lps`, a stack of k
    of them on a leading axis).  ``n_var``/``n_ineq``/``n_eq`` are the
    real (unpadded) sizes; the tensors may be larger (padded)."""

    c: torch.Tensor          # [N]      objective
    G: torch.Tensor          # [Mi, N]  inequality lhs
    h: torch.Tensor          # [Mi]     inequality rhs
    A: torch.Tensor          # [Me, N]  equality lhs
    b: torch.Tensor          # [Me]     equality rhs
    l: torch.Tensor          # [N]      lower bounds
    u: torch.Tensor          # [N]      upper bounds
    n_var: int = 0
    n_ineq: int = 0
    n_eq: int = 0

    @classmethod
    def build(cls, c: np.ndarray, G: Optional[np.ndarray] = None,
              h: Optional[np.ndarray] = None,
              A: Optional[np.ndarray] = None,
              b: Optional[np.ndarray] = None,
              l: Optional[np.ndarray] = None,
              u: Optional[np.ndarray] = None, pad_to: int = 128,
              dtype=torch.float32, device=None) -> "LinearProgram":
        """Build (and 128-pad) an LP from numpy parts on ``device`` (default:
        the CUDA device, see :func:`resolve_device`).  Missing blocks are
        zero-row placeholders so downstream code never branches."""
        device = resolve_device(device)
        c = np.asarray(c, np.float64)
        n = c.shape[0]
        G = np.zeros((0, n)) if G is None else np.asarray(G, np.float64)
        h = np.zeros((0,)) if h is None else np.asarray(h, np.float64)
        A = np.zeros((0, n)) if A is None else np.asarray(A, np.float64)
        b = np.zeros((0,)) if b is None else np.asarray(b, np.float64)
        l = np.full(n, -BIG) if l is None else np.asarray(l, np.float64)
        u = np.full(n, BIG) if u is None else np.asarray(u, np.float64)
        assert G.shape == (h.shape[0], n) and A.shape == (b.shape[0], n)

        N = _round_up(max(n, 1), pad_to)
        Mi = _round_up(max(G.shape[0], 1), pad_to)
        Me = _round_up(max(A.shape[0], 1), pad_to)

        cP = np.zeros(N); cP[:n] = c
        lP = np.zeros(N); lP[:n] = l          # padded vars pinned to 0
        uP = np.zeros(N); uP[:n] = u
        GP = np.zeros((Mi, N)); GP[: G.shape[0], :n] = G
        hP = np.full(Mi, BIG); hP[: h.shape[0]] = h
        AP = np.zeros((Me, N)); AP[: A.shape[0], :n] = A
        bP = np.zeros(Me); bP[: b.shape[0]] = b

        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(c=t(cP), G=t(GP), h=t(hP), A=t(AP), b=t(bP), l=t(lP),
                   u=t(uP), n_var=n, n_ineq=G.shape[0], n_eq=A.shape[0])

    @property
    def shape(self) -> tuple:
        """``(Mi, Me, N)`` of one LP (what :func:`stack_lps` matches)."""
        return (self.G.shape[0], self.A.shape[0], self.c.shape[0])

    def stacked(self):
        """K = [G; A], q = [h; b] and the >=0 dual mask for the K rows
        (along the row axis, so a stack from :func:`stack_lps` gives
        ``[k, M, N]``; one LP gives the reference's arrays)."""
        K = torch.cat([self.G, self.A], dim=-2)
        q = torch.cat([self.h, self.b], dim=-1)
        dev = self.h.device
        ineq_mask = torch.cat(
            [torch.ones(self.h.shape, dtype=torch.bool, device=dev),
             torch.zeros(self.b.shape, dtype=torch.bool, device=dev)],
            dim=-1)
        return K, q, ineq_mask

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.c @ x

    def violations(self, x: torch.Tensor) -> dict:
        """Constraint violation report (tests and feasibility checks)."""
        ineq = torch.clamp_min(self.G @ x - self.h, 0.0)
        eq = torch.abs(self.A @ x - self.b)
        box = (torch.clamp_min(self.l - x, 0.0)
               + torch.clamp_min(x - self.u, 0.0))
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return {
            "ineq_max": torch.max(ineq) if ineq.numel() else zero,
            "eq_max": torch.max(eq) if eq.numel() else zero,
            "box_max": torch.max(box) if box.numel() else zero,
        }


_FIELDS = ("c", "G", "h", "A", "b", "l", "u")


def stack_lps(lps: list) -> LinearProgram:
    """Stack k same-shaped LPs on a leading axis (POP's batched map step);
    partitioners guarantee equal padded shapes by construction."""
    assert len({lp.shape for lp in lps}) == 1, \
        "sub-problems must be same-shaped"
    proto = lps[0]
    return LinearProgram(
        *(torch.stack([getattr(lp, f) for lp in lps]) for f in _FIELDS),
        proto.n_var, proto.n_ineq, proto.n_eq)


@dataclasses.dataclass
class MixedIntegerProgram:
    """MILP = LP + integrality mask (``binary_mask`` marks the binary
    {0, 1} variables, padded to the LP's N with False)."""

    lp: LinearProgram
    binary_mask: torch.Tensor   # [N] bool

    @classmethod
    def build(cls, binary_mask: np.ndarray,
              **lp_kwargs) -> "MixedIntegerProgram":
        lp = LinearProgram.build(**lp_kwargs)
        m = np.zeros(lp.c.shape[0], bool)
        m[: binary_mask.shape[0]] = binary_mask
        return cls(lp=lp, binary_mask=torch.as_tensor(m,
                                                      device=lp.c.device))
