"""The judge of a run: the plain float64 reference, worked out again
from the deck (mesh, nodes, boundary values, initial field, BDF
schedule, GLS residual), holds the states the solver returned to the
equations they must satisfy.

It can only follow the solver step by step: each step's residual is
taken at the solver's own earlier states.  The start, the initial field,
is checked by itself (``ic_err``), and so are the Dirichlet values of
every judged state (``bc_err``, decks with Dirichlet rows).  The numbers:

- ``ic_err``: max |u0 - u0_ref| over every node and component;
- ``bc_err``: max |u - g| over the Dirichlet rows of every judged state;
- ``res_setup``: the largest l2 norm of the residual, over its free
  rows, of the set-up's solves (the BDF start-up);
- ``res_window``: the same over the window's judged steps.

The solver's node coordinates serve only to read its arrays: each node
has to lie on one reference node (periodic seams wrapped), or the run is
not correct.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from . import expr, meshes
from .gls import Residual, bdf_weights

STAB_KEYS = ("supg", "pspg", "gls viscous adjoint", "lsic")


def round_to_tf32(u: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at TF32's 10
    mantissa bits, returned as float32."""
    bits = u.detach().to(torch.float32).contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _bool(v: str) -> bool:
    return v.strip().lower() in ("true", "1", "yes", "on")


def schedule(deck: dict):
    """The BDF solves of the set-up's start, from the deck: a list of
    (history length k, step sizes newest first) per solve, each solve's
    new state following the chain u0, u1, ...  A BDF2 deck with a startup
    time scaling s in (0, 1) splits its first step into BDF1 over s dt
    and BDF2 over (1 - s) dt."""
    sc = deck["simulation control"]
    if sc["method"] != "bdf2":
        raise ValueError("the reference takes bdf2 decks")
    dt = float(sc["time step"])
    s = float(sc["startup time scaling"])
    if 0.0 < s < 1.0:
        return [(1, [s * dt]), (2, [(1 - s) * dt, s * dt]),
                (2, [dt, (1 - s) * dt])], dt
    return [(1, [dt])], dt


class Judge:
    """The reference for one deck on one device; ``prog_nodes`` [N, d]
    the solver's node coordinates, in its own order."""

    def __init__(self, deck: dict, dim: int, prog_nodes: np.ndarray,
                 device):
        self.deck, self.dim, self.device = deck, dim, device
        mesh = meshes.from_deck(deck, dim)
        self.mesh = mesh
        N, c = len(mesh.nodes), dim + 1
        self.c = c
        self.perm = self._match(np.asarray(prog_nodes, float))
        fem = deck["FEM"]
        stab = {k.replace(" ", "_"): _bool(deck["stabilization"][k])
                for k in STAB_KEYS}
        nq = int(fem.get("quadrature points", "0")) or None
        self._residual_args = (
            mesh.xe, mesh.elems, N, int(fem["velocity order"]),
            float(deck["physical properties"]["kinematic viscosity"]),
            stab, device, nq)
        self.residual = Residual(*self._residual_args)
        mask = np.zeros((N, c), bool)
        g = np.zeros((N, c))
        for bc in meshes._bcs(deck):
            kind = bc["type"]
            if kind in ("periodic", "outlet"):
                continue
            nodes = mesh.boundary[int(bc["id"])]
            if kind == "noslip":
                g[nodes, :dim] = 0.0
            elif kind == "function":
                text = "; ".join(
                    bc.get(k, {}).get("Function expression", "0")
                    for k in "uvw"[:dim])
                g[nodes, :dim] = expr.evaluate(text, mesh.nodes[nodes])
            else:
                raise ValueError(f"the reference has no {kind!r} boundary")
            mask[nodes, :dim] = True
        ic = deck["initial conditions"]
        if ic["type"] != "nodal":
            raise ValueError("the reference takes nodal initial fields")
        u0 = expr.evaluate(ic["uvwp"]["Function expression"], mesh.nodes)
        u0 = np.where(mask, g, u0[:, :c])
        kw = dict(dtype=torch.float64, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.g = torch.as_tensor(g, **kw)
        self.u0 = torch.as_tensor(u0, **kw)
        self.steps, self.dt = schedule(deck)

    def _match(self, prog: np.ndarray) -> torch.Tensor:
        """perm[i] = the reference node of the solver's node i."""
        ref = self.mesh.nodes
        tol = 1e-6 * self.mesh.h_min
        if len(prog) != len(ref):
            raise ValueError(f"the solver has {len(prog)} nodes, the "
                             f"reference {len(ref)}")
        lo = ref.min(0)
        period = np.zeros(self.dim)
        for bc in meshes._bcs(self.deck):
            if bc["type"] == "periodic":
                a = int(bc["periodic_direction"])
                parts = self.deck["mesh"]["grid arguments"].split(":")
                p0 = float(parts[1].split(",")[a])
                p1 = float(parts[2].split(",")[a])
                period[a] = p1 - p0
                lo[a] = p0
        wrapped = prog.copy()
        for a in np.nonzero(period)[0]:
            wrapped[:, a] = lo[a] + np.mod(prog[:, a] - lo[a] + tol,
                                           period[a]) - tol
        dist, idx = cKDTree(ref).query(wrapped)
        if dist.max() > tol or len(np.unique(idx)) != len(idx):
            raise ValueError(f"the solver's nodes do not lie on the "
                             f"reference's (largest distance {dist.max():.3g})")
        return torch.as_tensor(idx, device=self.device)

    def ref_order(self, u) -> torch.Tensor:
        """A solver state [N, c] in the reference's node order, float64."""
        out = torch.empty((len(self.perm), self.c), dtype=torch.float64,
                          device=self.device)
        out[self.perm] = torch.as_tensor(u).to(self.device, torch.float64)
        return out

    def ic_err(self, u0) -> float:
        return float((self.ref_order(u0) - self.u0).abs().max())

    def bc_err(self, u) -> float:
        diff = (self.ref_order(u) - self.g)[self.mask]
        return float(diff.abs().max()) if diff.numel() else 0.0

    def res(self, new, hist, dts) -> float:
        """||R(new)|| over the free rows for one BDF step with history
        ``hist`` (newest first) and steps ``dts`` (newest first)."""
        alpha = bdf_weights(dts)
        d = self.dim
        combo = torch.zeros((len(self.perm), d), dtype=torch.float64,
                            device=self.device)
        for a, h in zip(alpha[1:], hist):
            combo += float(a) * self.ref_order(h)[:, :d]
        R = self.residual(self.ref_order(new), combo, float(alpha[0]),
                          1.0 / dts[0])
        R[self.mask] = 0.0
        return float(torch.linalg.vector_norm(R))

    def f32_gap(self, new, hist, dts) -> float:
        """||R(new)|| over the free rows of the difference between this
        residual evaluated in float32 and in float64: the size of the
        float32 evaluation error at a solver state (a diagnostic)."""
        if not hasattr(self, "_r32"):
            self._r32 = Residual(*self._residual_args, dtype=torch.float32)
        alpha = bdf_weights(dts)
        d = self.dim
        combo = sum(float(a) * self.ref_order(h)[:, :d]
                    for a, h in zip(alpha[1:], hist))
        u = self.ref_order(new)
        R64 = self.residual(u, combo, float(alpha[0]), 1.0 / dts[0])
        R32 = self._r32(u.float(), combo.float(), float(alpha[0]),
                        1.0 / dts[0]).double()
        diff = R32 - R64
        diff[self.mask] = 0.0
        return float(torch.linalg.vector_norm(diff))

    def judge(self, chain, window) -> dict:
        """Numbers of a run: ``chain`` the set-up's states u0, u1, ... (one
        per solve of ``schedule`` after u0, and as many constant-dt steps
        after those as the set-up took); ``window`` a list of (new, prev,
        prev2) of the judged window steps."""
        out = {"ic_err": self.ic_err(chain[0])}
        steps = list(self.steps)
        while len(steps) < len(chain) - 1:
            steps.append((2, [self.dt, self.dt]))
        res_setup = 0.0
        for i, (k, dts) in enumerate(steps[:len(chain) - 1]):
            hist = [chain[i - j] for j in range(k)]
            res_setup = max(res_setup, self.res(chain[i + 1], hist, dts))
        out["res_setup"] = res_setup
        out["res_window"] = max(
            (self.res(new, [p1, p2], [self.dt, self.dt])
             for new, p1, p2 in window), default=0.0)
        if bool(self.mask.any()):
            out["bc_err"] = max(self.bc_err(u) for u in
                                list(chain) + [w[0] for w in window])
        return out
