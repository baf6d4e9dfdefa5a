"""The assembled simulation system and its matrix-free global operator.

Holds everything ``Solver::initialize`` computes in the reference
(src/Solver.cpp:167-261), re-expressed without ever forming the sparse D:

  A x = M x + dt^2 * sum_families D_f^T W_f^2 D_f x

is two gathers + a batched contraction + a segment scatter per family.
Because every element block of A is (local stiffness) ⊗ I3, A is
component-decoupled: we work with the N x N single-component operator and
treat the three coordinates as batched right-hand sides. (Only dynamic
contact penalties couple components; those are handled by the constrained
solvers on top.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from admm_elastic_tpu.ops import reduction as red
from admm_elastic_tpu.ops import stencil as stencil_mod
from admm_elastic_tpu.system.elements import PinBatch, TetBatch, TriBatch


@dataclasses.dataclass(frozen=True)
class System:
    """Static (per-initialize) simulation system."""

    masses: jax.Array  # [N] per-vertex scalar mass (x3 identical comps)
    tets: Tuple[TetBatch, ...]
    tris: Tuple[TriBatch, ...]
    pins: Optional[PinBatch]  # pins-as-energies (linsolver 0/2) or None
    dt: float  # static: A is assembled/prefactored for this dt

    @property
    def n_verts(self) -> int:
        return self.masses.shape[0]

    @property
    def dt2(self) -> float:
        return self.dt * self.dt


jax.tree_util.register_dataclass(
    System, data_fields=("masses", "tets", "tris", "pins"), meta_fields=("dt",)
)


# ---------------------------------------------------------------------------
# D applies (z layout: list of per-family arrays in order tets, tris, pins)
# ---------------------------------------------------------------------------

def Dx(system: System, x):
    """D x as a list of per-family local iterates.

    Layouts: tet families use SoA rows [9, T] and tri families SoA rows
    [6, T] (element axis last end-to-end, consumed directly by the SoA
    local step with no transposes); pins [P, 3].
    """
    out = []
    for b in system.tets:
        if b.stencil is not None:
            out.append(stencil_mod.tet_Dx_rows(x, b))
        else:
            out.append(red.tet_Dx_rows(x, b.inds, b.Dlocal))
    for b in system.tris:
        if b.stencil is not None:
            out.append(stencil_mod.tri_Dx_rows(x, b))
        else:
            out.append(red.tri_Dx_rows(x, b.inds, b.Dlocal))
    if system.pins is not None:
        out.append(red.pin_Dx(x, system.pins.idx))
    return out


def zeros_like_Dx(system: System, dtype):
    """Zero-initialized per-family local iterates (same shapes as Dx).

    The ADMM carry's initial z is overwritten by the first local step
    before any read, so allocating zeros avoids one full D apply per step.
    """
    out = [jnp.zeros((9, b.n), dtype) for b in system.tets]
    out += [jnp.zeros((6, b.n), dtype) for b in system.tris]
    if system.pins is not None:
        out.append(jnp.zeros((system.pins.n, 3), dtype))
    return out


def _tet_DtW2(b: TetBatch, g, n):
    w2 = (b.weight * b.weight)[None, :]  # rows layout [9, T]
    if b.stencil is not None:
        return stencil_mod.tet_Dt_rows(w2 * g, b, n)
    return red.tet_Dt_rows(w2 * g, b.inds, b.Dlocal, n, b.gather_idx)


def _tri_DtW2(b: TriBatch, g, n):
    w2 = (b.weight * b.weight)[None, :]  # rows layout [6, T]
    if b.stencil is not None:
        return stencil_mod.tri_Dt_rows(w2 * g, b, n)
    return red.tri_Dt_rows(w2 * g, b.inds, b.Dlocal, n, b.gather_idx)


def DtW2(system: System, g_list):
    """sum_f D_f^T W_f^2 g_f -> [N,3] (no dt^2 factor)."""
    n = system.n_verts
    i = 0
    parts = []
    for b in system.tets:
        parts.append(_tet_DtW2(b, g_list[i], n))
        i += 1
    for b in system.tris:
        parts.append(_tri_DtW2(b, g_list[i], n))
        i += 1
    if system.pins is not None:
        w2 = (system.pins.weight * system.pins.weight)[:, None]
        parts.append(red.pin_Dt(w2 * g_list[i], system.pins.idx, n, system.pins.gather_idx))
        i += 1
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def A_mv(system: System, x):
    """A x = M x + dt^2 D^T W^2 D x, for x [N,3] (or [N,k] batched RHS)."""
    return system.masses[:, None] * x + system.dt2 * DtW2(system, Dx(system, x))


def diag_A(system: System):
    """diag of the single-component N x N operator (all 3 comps equal)."""
    n = system.n_verts
    d = system.masses
    for b in system.tets:
        d = d + system.dt2 * red.tet_diag(b.weight * b.weight, b.Dlocal, b.inds, n)
    for b in system.tris:
        d = d + system.dt2 * red.tri_diag(b.weight * b.weight, b.Dlocal, b.inds, n)
    if system.pins is not None:
        d = d + system.dt2 * red.pin_diag(system.pins.weight**2, system.pins.idx, n)
    return d


def local_step(system: System, x, z_list, u_list, n_newton_iters: int = 8):
    """One ADMM local step over all families.

    zi = prox(D_i x + u_i); u_i += D_i x - z_i (src/EnergyTerm.hpp:130-140).
    Tet families run the fused rows-native path (TetBatch.local_step_rows
    computes both z and the dual update).
    """
    dix_list = Dx(system, x)
    batches = list(system.tets) + list(system.tris) + ([system.pins] if system.pins is not None else [])
    new_z, new_u = [], []
    for b, dix, u in zip(batches, dix_list, u_list):
        fused = getattr(b, "local_step_rows", None)
        if fused is not None:
            zi, ui = fused(dix, u, n_newton_iters)
        else:
            zi = b.prox(dix + u, n_newton_iters)
            ui = u + dix - zi
        new_u.append(ui)
        new_z.append(zi)
    return new_z, new_u


def rhs(system: System, M_xbar, z_list, u_list):
    """b = M x_bar + dt^2 D^T W^2 (z - u) (src/Solver.cpp:98)."""
    n = system.n_verts
    i = 0
    parts = []
    for b in system.tets:
        parts.append(_tet_DtW2(b, z_list[i] - u_list[i], n))
        i += 1
    for b in system.tris:
        parts.append(_tri_DtW2(b, z_list[i] - u_list[i], n))
        i += 1
    if system.pins is not None:
        w2 = (system.pins.weight * system.pins.weight)[:, None]
        parts.append(red.pin_Dt(w2 * (z_list[i] - u_list[i]),
                                system.pins.idx, n, system.pins.gather_idx))
        i += 1
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return M_xbar + system.dt2 * out


def total_energy(system: System, x):
    """sum of element energies at x (debugging aid, reference
    EnergyTerm::energy wrappers src/EnergyTerm.hpp:142-148)."""
    dix_list = Dx(system, x)
    batches = list(system.tets) + list(system.tris)
    total = jnp.asarray(0.0, x.dtype)
    for b, dix in zip(batches, dix_list):
        if dix.ndim == 2:  # rows -> [T, 3, 3] or [T, 3, 2]
            cols = dix.shape[0] // 3
            dix = dix.T.reshape(-1, 3, cols)
        total = total + jnp.sum(b.energy(dix))
    return total


# ---------------------------------------------------------------------------
# Simulation state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic simulation state (a pure pytree; the whole checkpoint).

    The reference's entire state is (m_x, m_v) (src/Solver.hpp:66-67); we
    add the Uzawa multiplier warm-start carried across solves
    (src/UzawaCG.hpp:68-74) and the previous active-constraint row mask
    used to decide when to reset it. The reference gates the warm start on
    the constraint *count* only (cheap in its dynamic structures); our
    fixed-capacity row masks make exact set comparison a trivial vector
    compare, and count-gating is measurably unsafe: when the active set
    seesaws between different same-sized subsets (observed on a resting
    box, 2-of-4 floor verts alternating), stale multipliers are reapplied
    to different rows every iteration and the contact force systematically
    under-resolves until the body tunnels.
    """

    x: jax.Array  # [N, 3]
    v: jax.Array  # [N, 3]
    y: jax.Array  # [2*Hcap] Uzawa multipliers (size 0 if unused)
    prev_active: jax.Array  # bool [2*Hcap] previous active constraint rows


jax.tree_util.register_dataclass(
    SimState, data_fields=("x", "v", "y", "prev_active"), meta_fields=()
)


def init_state(x, n_constraint_rows: int = 0) -> SimState:
    x = jnp.asarray(x)
    return SimState(
        x=x,
        v=jnp.zeros_like(x),
        y=jnp.zeros((n_constraint_rows,), dtype=x.dtype),
        prev_active=jnp.zeros((n_constraint_rows,), dtype=bool),
    )
