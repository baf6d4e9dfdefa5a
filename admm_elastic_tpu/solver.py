"""The Solver: scene staging, one-time initialize, and the jitted timestep.

API mirrors the reference ``admm::Solver`` (src/Solver.hpp:63-104):
``add_nodes``, ``set_pins``, ``add_obstacle``, ``add_dynamic_collider``,
``initialize``, ``step``, ``runtime_data``, ``save_matrix``, plus
energy-term registration helpers replacing ``create_*_from_mesh``.

The whole timestep (src/Solver.cpp:35-109) compiles to ONE XLA program:

    v += explicit forces; v_y += dt*g
    x_bar = x + dt v;  z = D x;  u = 0;  curr_x = x_bar
    fori admm_iters:                       # dynamic bound -> no recompiles
        local:   z,u <- prox(D curr_x + u)        (batched per family)
        detect:  masked hit buffers at curr_x
        global:  b = M x_bar + dt^2 D^T W^2 (z-u); solve A curr_x = b
    v = (curr_x - x)/dt; x = curr_x
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from admm_elastic_tpu import config as cfg
from admm_elastic_tpu.collision import constraints as con
from admm_elastic_tpu.collision.dynamic import TetMeshCollider, detect_dynamic
from admm_elastic_tpu.collision.passive import detect_passive
from admm_elastic_tpu.config import Settings
from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.solvers import alcg as alcg_mod
from admm_elastic_tpu.solvers import anderson as anderson_mod
from admm_elastic_tpu.solvers import direct as direct_mod
from admm_elastic_tpu.solvers import gs as gs_mod
from admm_elastic_tpu.solvers import pcg as pcg_mod
from admm_elastic_tpu.solvers import uzawa as uzawa_mod
from admm_elastic_tpu.system import assembly
from admm_elastic_tpu.system import elements as el
from admm_elastic_tpu.system import system as sysm


@dataclasses.dataclass(frozen=True)
class GSData:
    ell_cols: jax.Array
    ell_vals: jax.Array
    diag: jax.Array
    colors: jax.Array
    colors_mask: jax.Array


jax.tree_util.register_dataclass(
    GSData, data_fields=("ell_cols", "ell_vals", "diag", "colors", "colors_mask"), meta_fields=()
)


@dataclasses.dataclass
class RuntimeData:
    """Per-step timing log (reference src/Solver.hpp:54-61)."""

    global_ms: float = 0.0
    local_ms: float = 0.0
    collision_ms: float = 0.0
    step_ms: float = 0.0
    inner_iters: int = 0
    # True if any fixed-capacity collision stage dropped a contact during
    # the step(s) this record covers (hash-grid cell cap / HIT_CAP,
    # collision/dynamic.py) — the "no silent drops" accounting surfaced.
    collision_overflow: bool = False

    def print(self, settings: Settings):
        it = max(settings.admm_iters, 1)
        print(f"\nTotal step: {self.step_ms}ms")
        print(f"Total global step: {self.global_ms}ms")
        print(f"Total local step: {self.local_ms}ms")
        print(f"Total collision update: {self.collision_ms}ms")
        print(f"ADMM Iters: {settings.admm_iters}")
        print(f"Avg Inner Iters: {self.inner_iters / it}")
        if self.collision_overflow:
            print("WARNING: collision buffers overflowed (contacts dropped)")


# ---------------------------------------------------------------------------
# The jitted step
# ---------------------------------------------------------------------------

def _detect(obstacles, colliders, x, surf_inds, with_passive: bool, dtype,
            dense_surf: bool = False):
    """One round of collision detection into fixed-capacity buffers.

    Mirrors Collider::detect (src/Collider.hpp:152-212): deepest passive
    hit per vertex across obstacles; first dynamic hit per vertex across
    colliders (the reference resolves one dynamic collision at a time,
    src/DynamicObject.hpp:73). dense_surf (static) marks surf_inds ==
    arange(N): the query gather and every C/C^T hit-row gather/scatter
    downstream become identity ops (collision/constraints.Hits.dense).
    """
    hits = con.empty_hits(surf_inds, dtype, dense=dense_surf,
                          may_dyn=bool(colliders))
    if surf_inds.shape[0] == 0:
        return hits
    xs = x if dense_surf else x[surf_inds]
    if obstacles and with_passive:
        dx, point, normal, mask, p_ovf = detect_passive(obstacles, xs)
        hits = dataclasses.replace(hits, p_mask=mask, p_normal=normal,
                                   p_point=point,
                                   overflow=hits.overflow | p_ovf)
    if colliders:
        d_mask = jnp.zeros((surf_inds.shape[0],), dtype=bool)
        d_face = jnp.zeros((surf_inds.shape[0], 3), dtype=jnp.int32)
        d_barys = jnp.zeros((surf_inds.shape[0], 3), dtype=dtype)
        d_normal = jnp.zeros((surf_inds.shape[0], 3), dtype=dtype)
        overflow = hits.overflow
        for c in colliders:
            res = detect_dynamic(c, x, xs, surf_inds)
            take = res["mask"] & ~d_mask
            d_face = jnp.where(take[:, None], res["face"], d_face)
            d_barys = jnp.where(take[:, None], res["barys"], d_barys)
            d_normal = jnp.where(take[:, None], res["normal"], d_normal)
            d_mask = d_mask | res["mask"]
            # Capacity-drop accounting: any cell-cap or HIT_CAP overflow
            # means a contact was deferred/lost this iteration.
            overflow = overflow | jnp.any(res["broad_overflow"]) | res["hit_overflow"]
        hits = dataclasses.replace(
            hits, d_mask=d_mask, d_face=d_face, d_barys=d_barys,
            d_normal=d_normal, overflow=overflow,
        )
    return hits


def _make_apply_Ainv(system, solve_data, params, refine_passes: int):
    """The prefactored/iterative A^-1 apply shared by the LDLT and Uzawa
    global steps (and by step_profiled, so profiled runs use the same
    numerics as the fused path).

    Two operator flavors:
    - DirectData (dense equilibrated inverse / Cholesky): solve + optional
      iterative-refinement passes + pin-row Jacobi polish.
    - PCGData (sparse ELL + Jacobi/two-grid preconditioner): an inner PCG
      solve to uzawa_inner_tol — the O(nnz) replacement for the reference's
      SimplicialLDLT prefactor (src/LinearSolver.hpp:79-84) that lets
      UzawaCG run at mesh sizes where a dense N x N inverse cannot exist.
    """
    if isinstance(solve_data, pcg_mod.PCGData):
        precond_T = solve_data.precondition_T()

        def apply_Ainv(rhs_, x0=None):
            x0 = jnp.zeros_like(rhs_) if x0 is None else x0
            xx, _ = pcg_mod.solve_T(
                solve_data.apply_T, precond_T, rhs_, x0,
                params["uzawa_inner_tol"], params["uzawa_inner_iters"],
            )
            return xx

        return apply_Ainv

    def apply_Ainv(rhs_, x0=None):
        # Prefactored solve + iterative-refinement passes: each recovers
        # digits the f32 A^-1 matmul loses to conditioning (pins put
        # ~dt^2*w_pin^2 / mass ~ 1e5 on the diagonal) at the cost of one
        # matrix-free A apply + one extra solve.
        del x0  # exact solve; warm start meaningless
        xx = direct_mod.solve(solve_data, rhs_)
        for _ in range(refine_passes):
            # NOTE: the residual must use the FACTORED matrix-free apply
            # (M x + dt^2 D^T W^2 (D x)) — a dense f32 A @ x loses ~3 digits
            # to cancellation across the pin-scaled rows and makes the
            # "refinement" actively harmful (measured 0.88 vs 7e-3 relative
            # trajectory error on the 50-step beam).
            r = rhs_ - sysm.A_mv(system, xx)
            xx = xx + direct_mod.solve(solve_data, r)
        # Pin-row Jacobi polish: restores hard-pin accuracy in f32 for the
        # cost of one tiny gather (see solvers/direct.polish).
        return direct_mod.polish(solve_data, xx, rhs_)

    return apply_Ainv


def _step_core(
    system: sysm.System,
    solve_data,
    obstacles,
    colliders,
    wind_forces,
    surf_inds,
    pin_mask,
    pin_target,
    state: sysm.SimState,
    params: Dict,
    *,
    linsolver: int,
    prox_iters: int,
    with_passive: bool,
    refine_passes: int = 1,
    unroll_admm_iters: int = 0,
    aa_window: int = 0,
    dense_surf: bool = False,
):
    dt = system.dt
    dtype = state.x.dtype
    x0, v = state.x, state.v
    masses = system.masses

    # Explicit forces then gravity kick (src/Solver.cpp:53-59).
    for f in wind_forces:
        v = f.project(dt, x0, v, masses)
    v = v.at[:, 1].add(dt * params["gravity"])

    x_bar = x0 + dt * v
    M_xbar = masses[:, None] * x_bar
    # z is fully overwritten by the first local step; u starts at 0 each
    # step (src/Solver.cpp:70-72) — so both are just zero allocations.
    z = sysm.zeros_like_Dx(system, dtype)
    u = [jnp.zeros_like(zi) for zi in z]

    apply_Ainv = _make_apply_Ainv(system, solve_data, params, refine_passes)

    def do_global(b, curr_x, hits, y, n_prev):
        """One GLOBAL solve (src/Solver.cpp:98-99) with the configured mode."""
        if linsolver == cfg.LDLT:
            return apply_Ainv(b), y, n_prev, jnp.asarray(1, jnp.int32)
        if linsolver == cfg.NCMCGS:
            hits_dyn = dataclasses.replace(hits, p_mask=jnp.zeros_like(hits.p_mask))
            x_new, it = gs_mod.solve(
                solve_data.ell_cols,
                solve_data.ell_vals,
                solve_data.diag,
                solve_data.colors,
                solve_data.colors_mask,
                b,
                curr_x,
                pin_mask,
                pin_target,
                obstacles,
                hits_dyn,
                params["ck"],
                params["omega"],
                params["gs_max_iters"],
                params["gs_tol"],
                # Static: no registered colliders -> d_mask identically
                # False -> the penalty pipeline is dead code.
                may_have_dyn=bool(colliders),
            )
            return x_new, y, n_prev, it
        if linsolver == cfg.UZAWACG:
            hits = hits.dedup()
            # Warm-start gate: keep y only when the active SET is unchanged
            # (stricter than the reference's count gate, src/UzawaCG.hpp:
            # 68-74 — see SimState docstring for why count-gating tunnels).
            act = jnp.concatenate([hits.p_mask, hits.d_mask])
            y = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
            x_new, y, it = uzawa_mod.solve(
                apply_Ainv,
                hits,
                params["ck"],
                b,
                curr_x,
                y,
                params["uzawa_max_iters"],
                params["uzawa_tol"],
            )
            return x_new, y, act, it
        if linsolver == cfg.PCG:
            x_new, it = pcg_mod.solve_T(
                solve_data.apply_T,
                solve_data.precondition_T(),
                b,
                curr_x,
                params["pcg_tol"],
                params["pcg_max_iters"],
            )
            return x_new, y, n_prev, it
        if linsolver == cfg.ALPCG:
            hits = hits.dedup()
            act = jnp.concatenate([hits.p_mask, hits.d_mask])
            y = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
            x_new, y, it = alcg_mod.solve(
                solve_data, hits, params["ck"], b, curr_x, y,
                params["pcg_tol"], params["pcg_max_iters"],
            )
            return x_new, y, act, it
        raise ValueError(f"unknown linsolver {linsolver}")

    def admm_iter(_, carry):
        curr_x, z, u, y, n_prev, tot, ovf = carry
        # LOCAL (src/Solver.cpp:84-87)
        z, u = sysm.local_step(system, curr_x, z, u, prox_iters)
        # COLLISION (src/Solver.cpp:92-93)
        hits = _detect(obstacles, colliders, curr_x, surf_inds, with_passive, dtype, dense_surf)
        b = sysm.rhs(system, M_xbar, z, u)
        curr_x, y, n_prev, it = do_global(b, curr_x, hits, y, n_prev)
        return (curr_x, z, u, y, n_prev, tot + it, ovf | hits.overflow)

    # --- Anderson-accelerated variant: the same local+global iteration seen
    # as the Douglas-Rachford map v -> g(v) on v = D x + u, with safeguarded
    # type-II extrapolation (solvers/anderson.py).
    batches = (
        list(system.tets) + list(system.tris)
        + ([system.pins] if system.pins is not None else [])
    )

    def _flat(v_list):
        return jnp.concatenate([vi.reshape(-1) for vi in v_list])

    def _unflat(vec, like):
        out, o = [], 0
        for ref in like:
            n = ref.size
            out.append(vec[o:o + n].reshape(ref.shape))
            o += n
        return out

    def admm_iter_aa(_, carry):
        v_flat, curr_x, y, n_prev, tot, aa, ovf = carry
        v_list = _unflat(v_flat, z)
        # LOCAL from v: z = prox(v), u = v - z.
        z_new = [b_.prox(vi, prox_iters) for b_, vi in zip(batches, v_list)]
        u_new = [vi - zi for vi, zi in zip(v_list, z_new)]
        hits = _detect(obstacles, colliders, curr_x, surf_inds, with_passive, dtype, dense_surf)
        b = sysm.rhs(system, M_xbar, z_new, u_new)
        x_new, y, n_prev, it = do_global(b, curr_x, hits, y, n_prev)
        gv = _flat([di + ui for di, ui in zip(sysm.Dx(system, x_new), u_new)])
        v_next, aa, _ = anderson_mod.update(
            aa, v_flat, gv, safeguard=params["aa_safeguard"]
        )
        return (v_next, x_new, y, n_prev, tot + it, aa, ovf | hits.overflow)

    ovf0 = jnp.asarray(False)
    if aa_window > 0:
        v0 = _flat(sysm.Dx(system, x_bar))
        carry0 = (v0, x_bar, state.y, state.prev_active,
                  jnp.asarray(0, jnp.int32), anderson_mod.init(aa_window, v0), ovf0)
        if unroll_admm_iters > 0:
            carry = carry0
            for _ in range(unroll_admm_iters):
                carry = admm_iter_aa(0, carry)
        else:
            carry = jax.lax.fori_loop(0, params["admm_iters"], admm_iter_aa, carry0)
        _, curr_x, y, n_prev, inner, _, ovf = carry
    else:
        carry0 = (x_bar, z, u, state.y, state.prev_active,
                  jnp.asarray(0, jnp.int32), ovf0)
        if unroll_admm_iters > 0:
            # Static unroll: lets XLA software-pipeline across ADMM iterations
            # (measured ~35% lower per-iteration overhead at bench scale) at the
            # cost of a admm_iters-times larger program. params["admm_iters"] is
            # ignored on this path.
            carry = carry0
            for _ in range(unroll_admm_iters):
                carry = admm_iter(0, carry)
            curr_x, z, u, y, n_prev, inner, ovf = carry
        else:
            curr_x, z, u, y, n_prev, inner, ovf = jax.lax.fori_loop(
                0, params["admm_iters"], admm_iter, carry0
            )

    v_new = (curr_x - x0) * (1.0 / dt)
    new_state = sysm.SimState(x=curr_x, v=v_new, y=y, prev_active=n_prev)
    return new_state, inner, ovf


_step_impl = jax.jit(_step_core, static_argnames=("linsolver", "prox_iters", "with_passive", "refine_passes", "unroll_admm_iters", "aa_window", "dense_surf"))


def _run_core(system, solve_data, obstacles, colliders, wind_forces, surf_inds,
              pin_mask, pin_target, state, params, n_steps, *,
              linsolver: int, prox_iters: int, with_passive: bool,
              refine_passes: int = 1, unroll_admm_iters: int = 0,
              aa_window: int = 0, dense_surf: bool = False):
    """n_steps timesteps fully on device (no host sync between steps).

    Returns (state, overflow): overflow is the sticky OR of every step's
    collision-capacity flag so a dropped contact anywhere in the rollout
    is still visible at the end."""

    def body(_, carry):
        st, ovf = carry
        st, _, ovf_step = _step_core(
            system, solve_data, obstacles, colliders, wind_forces, surf_inds,
            pin_mask, pin_target, st, params,
            linsolver=linsolver, prox_iters=prox_iters, with_passive=with_passive,
            refine_passes=refine_passes, unroll_admm_iters=unroll_admm_iters,
            aa_window=aa_window, dense_surf=dense_surf,
        )
        return st, ovf | ovf_step

    return jax.lax.fori_loop(0, n_steps, body, (state, jnp.asarray(False)))


_run_impl = jax.jit(_run_core, static_argnames=("linsolver", "prox_iters", "with_passive", "refine_passes", "unroll_admm_iters", "aa_window", "dense_surf"))


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class Solver:
    """Scene container + simulation driver (reference admm::Solver)."""

    def __init__(self, settings: Optional[Settings] = None):
        self.m_settings = settings if settings is not None else Settings()
        self.initialized = False
        # Host staging.
        self._x_stage: List[np.ndarray] = []
        self._m_stage: List[np.ndarray] = []
        self._n_verts = 0
        self._tet_specs: List[Tuple] = []  # (verts, tets, lame, model, offset, kappa)
        self._tri_specs: List[Tuple] = []
        self._pins: Dict[int, np.ndarray] = {}
        self.surface_inds: List[int] = []
        self._surf_dense = False  # set at initialize
        self.obstacles: List = []
        self.colliders: List[TetMeshCollider] = []
        self.ext_forces: List = []
        # Built at initialize.
        self.system: Optional[sysm.System] = None
        self.state: Optional[sysm.SimState] = None
        self._solve_data = None
        self._surf_inds_dev = None
        self._pin_mask = None
        self._pin_target = None
        self._runtime = RuntimeData()
        # SolverLog tier (filled by step_logged; set .x_star beforehand for
        # error-vs-known-solution curves, reference src/SolverLog.hpp:36-55).
        from admm_elastic_tpu.utils.logging import InnerLog

        self.solver_log = InnerLog(residuals=np.zeros((0, 0)))

    # -- staging API --------------------------------------------------------

    def add_nodes(self, x: np.ndarray, m: np.ndarray) -> int:
        """Append vertices; returns total vertex count (src/Solver.hpp:127-141)."""
        x = np.asarray(x, dtype=np.float64).reshape(-1, 3)
        m = np.asarray(m, dtype=np.float64).reshape(-1)
        if m.shape[0] == 3 * x.shape[0]:  # accept x3-scaled masses
            m = m.reshape(-1, 3)[:, 0]
        assert m.shape[0] == x.shape[0]
        self._x_stage.append(x)
        self._m_stage.append(m)
        self._n_verts += x.shape[0]
        return self._n_verts

    def add_tet_energies(self, verts, tets, lame: Lame, model: str = "linear",
                         vertex_offset: int = 0, kappa: float = 0.0,
                         lattice_dims=None, lattice_wrap: bool = False):
        """Register a tet element family (create_tets_from_mesh equivalent,
        src/TetEnergyTerm.hpp:35-51). lattice_dims=(nx,ny,nz) marks a
        structured make_tet_blocks grid (verified against tets at build;
        enables the gather-free stencil D/D^T); lattice_wrap marks a
        periodic first axis (make_tet_torus ring lattices)."""
        self._tet_specs.append((np.asarray(verts, dtype=np.float64),
                                np.asarray(tets, dtype=np.int64), lame, model,
                                vertex_offset, kappa, lattice_dims,
                                lattice_wrap))

    def add_tri_energies(self, verts, tris, lame: Lame, vertex_offset: int = 0):
        """Register a triangle (cloth) family (src/TriEnergyTerm.hpp:31-46)."""
        self._tri_specs.append((np.asarray(verts, dtype=np.float64),
                                np.asarray(tris, dtype=np.int64), lame, vertex_offset))

    def add_obstacle(self, obj):
        self.obstacles.append(obj)

    def add_dynamic_collider(self, obj: TetMeshCollider):
        self.colliders.append(obj)

    def add_explicit_force(self, f):
        self.ext_forces.append(f)

    def set_pins(self, inds, points=None):
        """(Re)set the pin constraint set (src/Solver.cpp:113-157).

        Before initialize: defines the pinnable set. After initialize with
        the prefactored/Uzawa solvers, only targets/active flags of the
        *initial* pin set may change; raises otherwise.
        """
        inds = [int(i) for i in inds]
        pin_in_place = points is None or len(points) != len(inds)
        if pin_in_place and points is not None and len(points) > 0:
            raise ValueError("**Solver::set_pins Error: Bad input.")

        new_pins: Dict[int, np.ndarray] = {}
        x_now = self.x if self.initialized or self._n_verts else None
        for k, idx in enumerate(inds):
            if pin_in_place:
                if x_now is None:
                    raise ValueError("**Solver::set_pins Error: Bad input.")
                new_pins[idx] = np.asarray(x_now[idx], dtype=np.float64)
            else:
                new_pins[idx] = np.asarray(points[k], dtype=np.float64)
        self._pins = new_pins

        if not self.initialized:
            return

        ls = self.m_settings.linsolver
        if ls in (cfg.LDLT, cfg.UZAWACG, cfg.PCG, cfg.ALPCG):
            pins = self.system.pins
            if pins is None or pins.n == 0:
                if new_pins:
                    raise RuntimeError("**Solver::set_pins Error: Constraint not found.")
                return
            idx_np = np.asarray(pins.idx)
            lookup = {int(i): k for k, i in enumerate(idx_np)}
            active = np.zeros((pins.n,), dtype=bool)
            target = np.asarray(pins.target).copy()
            for idx, p in new_pins.items():
                if idx not in lookup:
                    raise RuntimeError(
                        f"**Solver::set_pins Error: Constraint for {idx} not found."
                    )
                k = lookup[idx]
                active[k] = True
                target[k] = p
            new_batch = dataclasses.replace(
                pins, target=jnp.asarray(target, dtype=target.dtype), active=jnp.asarray(active)
            )
            self.system = dataclasses.replace(self.system, pins=new_batch)
        # GS-mode pin arrays are rebuilt for any linsolver (harmless).
        self._rebuild_pin_arrays()

    def _rebuild_pin_arrays(self):
        n = self._n_verts
        dtype = self._dtype
        pm = np.zeros((n,), dtype=bool)
        pt = np.zeros((n, 3), dtype=np.float64)
        for idx, p in self._pins.items():
            pm[idx] = True
            pt[idx] = p
        self._pin_mask = jnp.asarray(pm)
        self._pin_target = jnp.asarray(pt, dtype=dtype)

    # -- convenience state views ---------------------------------------------

    @property
    def x(self) -> np.ndarray:
        if self.state is not None:
            return np.array(self.state.x)  # writable copy
        return np.concatenate(self._x_stage, axis=0) if self._x_stage else np.zeros((0, 3))

    @x.setter
    def x(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self.state is not None:
            self.state = dataclasses.replace(
                self.state, x=jnp.asarray(value, dtype=self._dtype)
            )
        else:
            self._x_stage = [value]
            self._m_stage = [np.concatenate(self._m_stage)] if self._m_stage else []
            self._n_verts = value.shape[0]

    @property
    def v(self) -> np.ndarray:
        return np.asarray(self.state.v) if self.state is not None else np.zeros((self._n_verts, 3))

    @v.setter
    def v(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        self.state = dataclasses.replace(self.state, v=jnp.asarray(value, dtype=self._dtype))

    @property
    def masses(self) -> np.ndarray:
        return np.concatenate(self._m_stage) if self._m_stage else np.zeros((0,))

    def settings(self) -> Settings:
        return self.m_settings

    def runtime_data(self) -> RuntimeData:
        return self._runtime

    # -- initialize -----------------------------------------------------------

    def initialize(self, settings: Optional[Settings] = None) -> bool:
        """Assemble the system, prefactor, build the jitted step
        (src/Solver.cpp:167-261)."""
        if settings is not None:
            self.m_settings = settings
        s = self.m_settings
        # What the caller configured, before any size-based auto-switch
        # rewrites m_settings.linsolver (introspection parity, ADVICE r2).
        self.requested_linsolver = s.linsolver
        if s.timestep_s <= 0.0:
            print(f"\n**Solver Error: timestep set to {s.timestep_s}s, changing to 1/24s.")
            s.timestep_s = 1.0 / 24.0

        # Current positions survive re-initialize (the reference keeps m_x and
        # only zeroes m_v, src/Solver.cpp:186-188).
        x_np = np.asarray(self.x, dtype=np.float64)
        m_np = np.concatenate(self._m_stage) if self._m_stage else np.zeros((0,))
        n = x_np.shape[0]
        if n < 1 or m_np.shape[0] != n:
            print("\n**Solver Error: Problem with node data!")
            return False
        self._n_verts = n
        dtype = cfg.resolve_dtype(s)
        self._dtype = dtype

        # Element batches.
        tets = tuple(
            el.build_tet_batch(v, t, lame, model, off, dtype=dtype, kappa=kap,
                               lattice_dims=dims, lattice_wrap=wrapf)
            for (v, t, lame, model, off, kap, dims, wrapf) in self._tet_specs
        )
        tris = tuple(
            el.build_tri_batch(v, t, lame, off, dtype=dtype)
            for (v, t, lame, off) in self._tri_specs
        )

        # Pin energies for the energy-based-pin paths (src/Solver.cpp:190-196;
        # PCG is our extension and takes pins as energies like LDLT).
        pins_batch = None
        if s.linsolver in (cfg.LDLT, cfg.UZAWACG, cfg.PCG, cfg.ALPCG) and self._pins:
            idxs = np.array(sorted(self._pins.keys()), dtype=np.int64)
            tgts = np.stack([self._pins[int(i)] for i in idxs])
            pins_batch = el.build_pin_batch(idxs, tgts, dtype=dtype)

        # Scatter-free D^T: per-family vertex->incident-corner gather tables
        # (ops.reduction.build_gather_table: a gather+sum over static
        # topology instead of a duplicate-index scatter-add).
        from admm_elastic_tpu.ops import reduction as red

        # Flat-stencil families never take the gather D^T path, so their
        # (large) vertex->corner tables are skipped entirely.
        tets = tuple(
            b if b.stencil is not None else dataclasses.replace(
                b, gather_idx=jnp.asarray(red.build_gather_table(np.asarray(b.inds), n))
            )
            for b in tets
        )
        tris = tuple(
            b if b.stencil is not None else dataclasses.replace(
                b, gather_idx=jnp.asarray(red.build_gather_table(np.asarray(b.inds), n))
            )
            for b in tris
        )
        if pins_batch is not None:
            pins_batch = dataclasses.replace(
                pins_batch,
                gather_idx=jnp.asarray(
                    red.build_gather_table(np.asarray(pins_batch.idx)[:, None], n)
                ),
            )

        self.system = sysm.System(
            masses=jnp.asarray(m_np, dtype=dtype),
            tets=tets,
            tris=tris,
            pins=pins_batch,
            dt=float(s.timestep_s),
        )

        # Constraint weight auto-selection (src/Solver.cpp:235,239).
        all_w = [np.asarray(b.weight) for b in tets] + [np.asarray(b.weight) for b in tris]
        max_w = max((float(w.max()) for w in all_w if w.size), default=1.0)
        if s.linsolver in (cfg.NCMCGS, cfg.ALPCG):
            # Penalty-type modes want heavy rows (3x the stiffest ADMM
            # weight, src/Solver.cpp:235); Uzawa enforces exactly (ck=1,
            # src/Solver.cpp:239).
            ck = max_w * 3.0
        else:
            ck = 1.0
        if s.constraint_w > 0.0:
            ck = s.constraint_w
        self._ck = np.sqrt(max(0.0, ck))  # rows are scaled by sqrt(w) (src/ConstraintSet.hpp:70)

        # Surface (query) vertex set: explicit surface_inds, else all
        # vertices when any collision object exists (src/Collider.hpp:158).
        has_cobjs = bool(self.obstacles or self.colliders)
        if self.surface_inds:
            surf = np.unique(np.asarray(self.surface_inds, dtype=np.int64))
        elif has_cobjs:
            surf = np.arange(n, dtype=np.int64)
        else:
            surf = np.zeros((0,), dtype=np.int64)
        self._surf_inds_dev = jnp.asarray(surf, dtype=jnp.int32)
        # Static: the default "query every vertex" surface makes all
        # hit-row gathers/scatters identity ops (Hits.dense fast path).
        self._surf_dense = bool(
            surf.shape[0] == n and np.array_equal(surf, np.arange(n)))

        # Global solver data.
        def _pin_rows():
            """ELL rows of A restricted to the pinned vertices (for the
            f32 pin-row polish, solvers/direct.polish)."""
            if self.system.pins is None or self.system.pins.n == 0:
                return None
            cols, vals, diag = assembly.assemble_ell(self.system, dtype=np.float64)
            idx = np.asarray(self.system.pins.idx)
            return idx, cols[idx], vals[idx], diag[idx]

        ls = s.linsolver
        if ls == cfg.LDLT and has_cobjs:
            # Checked BEFORE any size-based auto-switch: ls=0 forbids
            # collision objects at every size (src/Solver.cpp:249-254);
            # switching to PCG first would silently ignore the obstacles.
            raise RuntimeError(
                "**Solver::add_obstacle Error: No collisions with LDLT solver"
            )
        if ls == cfg.LDLT and n > s.direct_max_verts:
            # The reference's sparse LDLT works at any size; our dense
            # equivalent would need O(N^2) memory here. Serve ls=0 through
            # the ELL-PCG path at direct accuracy instead (tol clamps to
            # the dtype's floor, matching what the dense f32 solve
            # achieves anyway). The caller's Settings object is left
            # untouched — the override lives on a private copy (reusing
            # one Settings across solvers is normal).
            if s.verbose >= 1:
                print(f"**Solver::initialize: {n} verts exceeds "
                      f"direct_max_verts={s.direct_max_verts}; serving "
                      f"linsolver=0 via ELL-PCG (two-grid, tol 1e-10).")
            import copy

            s = copy.copy(s)
            self.requested_linsolver = cfg.LDLT
            s.linsolver = cfg.PCG
            s.pcg_precond = "twogrid"
            s.pcg_tol = min(s.pcg_tol, 1e-10)
            self.m_settings = s
            ls = cfg.PCG
        if ls == cfg.LDLT:
            A = assembly.assemble_dense(self.system)
            self._solve_data = direct_mod.prepare(
                A, dtype, mode=getattr(s, "direct_mode", "cho"), pin_rows=_pin_rows()
            )
        elif ls == cfg.NCMCGS:
            ell_cols, ell_vals, diag = assembly.assemble_ell(self.system, dtype=dtype)
            adj = assembly.vertex_adjacency(self.system)
            colors = assembly.greedy_coloring(adj)
            groups, gmask = assembly.color_groups(colors)
            self._solve_data = GSData(
                ell_cols=jnp.asarray(ell_cols),
                ell_vals=jnp.asarray(ell_vals),
                diag=jnp.asarray(diag),
                colors=jnp.asarray(groups),
                colors_mask=jnp.asarray(gmask),
            )
        elif ls == cfg.UZAWACG:
            inner = s.uzawa_inner
            if inner == "auto":
                inner = "direct" if n <= s.uzawa_dense_max_verts else "pcg"
                inner_precond = "twogrid"
            else:
                inner_precond = s.pcg_precond
            if inner == "direct":
                A = assembly.assemble_dense(self.system)
                self._solve_data = direct_mod.prepare(
                    A, dtype, mode=getattr(s, "direct_mode", "cho"), pin_rows=_pin_rows()
                )
            elif inner == "pcg":
                # Sparse O(nnz) inner operator: the reference's
                # SimplicialLDLT role (src/LinearSolver.hpp:79-84) at any
                # mesh size; each Uzawa Schur iteration runs an inner PCG
                # solve to uzawa_inner_tol.
                self._solve_data = pcg_mod.prepare(
                    self.system, dtype, precond=inner_precond
                )
            else:
                raise ValueError(f"unknown uzawa_inner {s.uzawa_inner!r}")
        elif ls in (cfg.PCG, cfg.ALPCG):
            self._solve_data = pcg_mod.prepare(
                self.system, dtype, precond=s.pcg_precond
            )
        else:
            raise ValueError(f"unknown linsolver {ls}")

        self._rebuild_pin_arrays()

        # State.
        cap = surf.shape[0]
        self.state = sysm.SimState(
            x=jnp.asarray(x_np, dtype=dtype),
            v=jnp.zeros((n, 3), dtype=dtype),
            y=jnp.zeros((2 * cap,), dtype=dtype),
            prev_active=jnp.zeros((2 * cap,), dtype=bool),
        )

        if s.verbose >= 1:
            n_terms = sum(b.n_real for b in tets) + sum(b.n_real for b in tris)
            n_terms += pins_batch.n if pins_batch is not None else 0
            print(f"{n} nodes, {n_terms} energy terms")
        self.initialized = True
        return True

    # -- stepping --------------------------------------------------------------

    @property
    def _refine_eff(self) -> int:
        """Effective iterative-refinement passes for the prefactored solve.

        The stored-inverse mode ("inv") in f32 on an UNPINNED system is
        unstable without refinement: A's smallest eigenvalues are the bare
        vertex masses (near-rigid modes), the f32 inverse-matmul error on
        those modes feeds v = (x_new - x0)/dt, and the feedback grows
        exponentially across steps (measured on the point-collapsed bunny:
        explodes to NaN by ~step 120 with 0 passes; recovers fully and
        stays at vmax ~1e-5 with one pass — as do "cho" and PCG, isolating
        the stored-inverse error as the driver). Pinned systems are
        covered by the pin-row polish and keep the round-1 default of 0.
        """
        s = self.m_settings
        if (isinstance(self._solve_data, direct_mod.DirectData)
                and self._solve_data.mode == "inv"
                and self._dtype == np.float32
                and (self.system is None or self.system.pins is None
                     or self.system.pins.n == 0)):
            return max(s.refine_passes, 1)
        return s.refine_passes

    def _params(self):
        s = self.m_settings
        dtype = self._dtype
        return dict(
            admm_iters=jnp.asarray(s.admm_iters, jnp.int32),
            gravity=jnp.asarray(s.gravity, dtype),
            ck=jnp.asarray(self._ck, dtype),
            omega=jnp.asarray(s.gs_omega, dtype),
            gs_max_iters=jnp.asarray(s.gs_max_iters, jnp.int32),
            gs_tol=jnp.asarray(s.gs_tol, dtype),
            uzawa_max_iters=jnp.asarray(s.uzawa_max_iters, jnp.int32),
            uzawa_tol=jnp.asarray(s.uzawa_tol, dtype),
            uzawa_inner_tol=jnp.asarray(s.uzawa_inner_tol, dtype),
            uzawa_inner_iters=jnp.asarray(s.uzawa_inner_iters, jnp.int32),
            pcg_max_iters=jnp.asarray(s.pcg_max_iters, jnp.int32),
            pcg_tol=jnp.asarray(s.pcg_tol, dtype),
            aa_safeguard=jnp.asarray(s.aa_safeguard, dtype),
        )

    def step(self):
        """Advance one timestep (src/Solver.cpp:35-109).

        verbose >= 2 uses the per-phase profiled path so the RuntimeData
        print shows local/collision/global wall-clock like the reference
        (src/Solver.cpp:309-319); verbose <= 1 runs the fused single
        program (phases not separable without device syncs).
        """
        assert self.initialized, "call initialize() first"
        s = self.m_settings
        if s.log_inner:
            return self.step_logged()
        if s.verbose >= 2:
            return self.step_profiled()
        if s.verbose > 0:
            print(f"\nSimulating with dt: {s.timestep_s}s...", end="", flush=True)
        t0 = time.perf_counter()
        new_state, inner, overflow = _step_impl(
            self.system,
            self._solve_data,
            tuple(self.obstacles),
            tuple(self.colliders),
            tuple(self.ext_forces),
            self._surf_inds_dev,
            self._pin_mask,
            self._pin_target,
            self.state,
            self._params(),
            linsolver=s.linsolver,
            prox_iters=s.prox_newton_iters,
            with_passive=(s.linsolver != cfg.NCMCGS),
            refine_passes=self._refine_eff,
            unroll_admm_iters=(s.admm_iters if s.unroll_admm else 0),
            aa_window=s.aa_window,
            dense_surf=self._surf_dense,
        )
        new_state = jax.block_until_ready(new_state)
        self.state = new_state
        self._runtime = RuntimeData(
            step_ms=(time.perf_counter() - t0) * 1e3, inner_iters=int(inner),
            collision_overflow=bool(overflow),
        )
        if self._runtime.collision_overflow and s.verbose >= 0:
            print("**Solver::step Warning: collision capacity overflow — "
                  "contacts were dropped this step (raise HIT_CAP/cell_cap).")
        if s.verbose > 0:
            self._runtime.print(s)

    def step_profiled(self):
        """One timestep with per-phase wall-clock timings (local / collision /
        global), filling RuntimeData like the reference's per-step print
        (src/Solver.hpp:54-61, src/Solver.cpp:83-100). Phases run as
        separate dispatches with device sync, so this is slower than
        step(); use for profiling only."""
        assert self.initialized, "call initialize() first"
        s = self.m_settings
        if s.aa_window > 0:
            raise ValueError(
                "step_profiled does not implement Anderson acceleration; "
                "set aa_window=0 or verbose<=1 (profiled numerics would "
                "silently differ from the fused path otherwise)."
            )
        system = self.system
        params = self._params()
        dt = system.dt
        rt = RuntimeData()
        t_all = time.perf_counter()

        x0, v = self.state.x, self.state.v
        for f in self.ext_forces:
            v = f.project(dt, x0, v, system.masses)
        v = v.at[:, 1].add(dt * params["gravity"])
        x_bar = x0 + dt * v
        M_xbar = system.masses[:, None] * x_bar
        z = sysm.Dx(system, x0)
        u = [jnp.zeros_like(zi) for zi in z]
        curr_x = x_bar
        y = self.state.y
        n_prev = self.state.prev_active
        dtype = self._dtype
        obstacles = tuple(self.obstacles)
        colliders = tuple(self.colliders)
        with_passive = s.linsolver != cfg.NCMCGS

        local_fn = jax.jit(partial(sysm.local_step, n_newton_iters=s.prox_newton_iters))
        detect_fn = jax.jit(partial(_detect, with_passive=with_passive, dtype=dtype, dense_surf=self._surf_dense))
        # Same A^-1 operator (refine_passes + polish / inner PCG) as the
        # fused path, so profiled runs match step() numerics exactly.
        apply_Ainv = _make_apply_Ainv(system, self._solve_data, params, self._refine_eff)

        def global_fn(b, curr_x, hits, y, n_prev):
            if s.linsolver == cfg.LDLT:
                return apply_Ainv(b), y, n_prev, jnp.asarray(1, jnp.int32)
            if s.linsolver == cfg.NCMCGS:
                hd = dataclasses.replace(hits, p_mask=jnp.zeros_like(hits.p_mask))
                x, it = gs_mod.solve(
                    self._solve_data.ell_cols, self._solve_data.ell_vals,
                    self._solve_data.diag, self._solve_data.colors,
                    self._solve_data.colors_mask, b, curr_x, self._pin_mask,
                    self._pin_target, obstacles, hd, params["ck"],
                    params["omega"], params["gs_max_iters"], params["gs_tol"],
                    may_have_dyn=bool(colliders))
                return x, y, n_prev, it
            if s.linsolver == cfg.UZAWACG:
                hits = hits.dedup()
                act = jnp.concatenate([hits.p_mask, hits.d_mask])
                y2 = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
                x, y3, it = uzawa_mod.solve(
                    apply_Ainv, hits,
                    params["ck"], b, curr_x, y2, params["uzawa_max_iters"],
                    params["uzawa_tol"])
                return x, y3, act, it
            if s.linsolver == cfg.ALPCG:
                hits = hits.dedup()
                act = jnp.concatenate([hits.p_mask, hits.d_mask])
                y2 = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
                x, y3, it = alcg_mod.solve(
                    self._solve_data, hits, params["ck"], b, curr_x, y2,
                    params["pcg_tol"], params["pcg_max_iters"])
                return x, y3, act, it
            x, it = pcg_mod.solve(self._solve_data.apply,
                                  self._solve_data.precondition(), b, curr_x,
                                  params["pcg_tol"], params["pcg_max_iters"])
            return x, y, n_prev, it

        global_jit = jax.jit(global_fn)
        rhs_jit = jax.jit(partial(sysm.rhs, system))

        for _ in range(s.admm_iters):
            t = time.perf_counter()
            z, u = jax.block_until_ready(local_fn(system, curr_x, z, u))
            rt.local_ms += (time.perf_counter() - t) * 1e3

            t = time.perf_counter()
            hits = jax.block_until_ready(
                detect_fn(obstacles, colliders, curr_x, self._surf_inds_dev))
            rt.collision_ms += (time.perf_counter() - t) * 1e3
            rt.collision_overflow |= bool(hits.overflow)

            t = time.perf_counter()
            b = rhs_jit(M_xbar, z, u)
            curr_x, y, n_prev, it = jax.block_until_ready(
                global_jit(b, curr_x, hits, y, n_prev))
            rt.global_ms += (time.perf_counter() - t) * 1e3
            rt.inner_iters += int(it)

        v_new = (curr_x - x0) * (1.0 / dt)
        self.state = sysm.SimState(x=curr_x, v=v_new, y=y, prev_active=n_prev)
        rt.step_ms = (time.perf_counter() - t_all) * 1e3
        self._runtime = rt
        if s.verbose > 0:
            rt.print(s)
        return rt

    def step_logged(self):
        """One timestep recording per-inner-iteration residual curves for
        every global solve (SolverLog parity, src/SolverLog.hpp:36-64,
        hooked at src/NodalMultiColorGS.hpp:61,135,144 and
        src/UzawaCG.hpp:59,112,122). Each global solve runs a fixed-length
        traced variant (no early exit), so the curves are shape-static
        [admm_iters, n_inner] and cost ~one extra solve, not per-iteration
        host syncs. Set ``solver.solver_log.x_star`` beforehand to also
        record normalized error-vs-known-solution like the reference.
        Results land in ``solver.solver_log`` (utils/logging.InnerLog)."""
        from admm_elastic_tpu.utils import logging as log_utils

        assert self.initialized, "call initialize() first"
        s = self.m_settings
        if s.aa_window > 0:
            raise ValueError("step_logged does not implement Anderson "
                             "acceleration; set aa_window=0.")
        system = self.system
        params = self._params()
        dt = system.dt
        dtype = self._dtype
        n_inner = s.log_inner_iters or {
            cfg.LDLT: 1, cfg.NCMCGS: s.gs_max_iters,
            cfg.UZAWACG: s.uzawa_max_iters, cfg.PCG: s.pcg_max_iters,
            cfg.ALPCG: s.pcg_max_iters,
        }[s.linsolver]
        x_star_np = getattr(self.solver_log, "x_star", None)
        x_star = (jnp.asarray(x_star_np, dtype)
                  if x_star_np is not None
                  and np.shape(x_star_np) == self.state.x.shape else None)
        # Reference semantics: SolverLog's x0 (the error normalizer) is the
        # iterate at the FIRST recorded inner iteration of the whole run,
        # not per solve (src/SolverLog.hpp:42-47: m_x0 captured once until
        # reset). Normalize every curve by the pre-step distance.
        err_denom = (jnp.maximum(jnp.linalg.norm(x_star - self.state.x),
                                 jnp.finfo(dtype).tiny)
                     if x_star is not None else None)

        x0, v = self.state.x, self.state.v
        for f in self.ext_forces:
            v = f.project(dt, x0, v, system.masses)
        v = v.at[:, 1].add(dt * params["gravity"])
        x_bar = x0 + dt * v
        M_xbar = system.masses[:, None] * x_bar
        z = sysm.zeros_like_Dx(system, dtype)
        u = [jnp.zeros_like(zi) for zi in z]
        curr_x = x_bar
        y = self.state.y
        n_prev = self.state.prev_active
        obstacles = tuple(self.obstacles)
        colliders = tuple(self.colliders)
        with_passive = s.linsolver != cfg.NCMCGS

        local_fn = jax.jit(partial(sysm.local_step, n_newton_iters=s.prox_newton_iters))
        detect_fn = jax.jit(partial(_detect, with_passive=with_passive, dtype=dtype, dense_surf=self._surf_dense))
        apply_Ainv = _make_apply_Ainv(system, self._solve_data, params, self._refine_eff)

        def global_traced(b, curr_x, hits, y, n_prev):
            zero = jnp.zeros((n_inner,), dtype)
            if s.linsolver == cfg.LDLT:
                x = apply_Ainv(b)
                res = jnp.linalg.norm(b - sysm.A_mv(system, x))
                err = (jnp.linalg.norm(x_star - x) / err_denom
                       if x_star is not None else jnp.asarray(0.0, dtype))
                return (x, y, n_prev, jnp.full((n_inner,), res, dtype),
                        jnp.full((n_inner,), err, dtype))
            if s.linsolver == cfg.NCMCGS:
                hd = dataclasses.replace(hits, p_mask=jnp.zeros_like(hits.p_mask))
                x, tr = gs_mod.solve_traced(
                    self._solve_data.ell_cols, self._solve_data.ell_vals,
                    self._solve_data.diag, self._solve_data.colors,
                    self._solve_data.colors_mask, b, curr_x, self._pin_mask,
                    self._pin_target, obstacles, hd, params["ck"],
                    params["omega"], n_inner, x_star=x_star,
                    err_denom=err_denom, may_have_dyn=bool(colliders))
                return x, y, n_prev, tr["res"], (tr["err"] if x_star is not None else zero)
            if s.linsolver == cfg.UZAWACG:
                hits = hits.dedup()
                act = jnp.concatenate([hits.p_mask, hits.d_mask])
                y2 = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
                x, y3, tr = uzawa_mod.solve_traced(
                    apply_Ainv, hits, params["ck"], b, curr_x, y2, n_inner,
                    x_star=x_star, err_denom=err_denom)
                return x, y3, act, tr["res"], (tr["err"] if x_star is not None else zero)
            if s.linsolver == cfg.ALPCG:
                hits = hits.dedup()
                act = jnp.concatenate([hits.p_mask, hits.d_mask])
                y2 = jnp.where(jnp.all(act == n_prev), y, jnp.zeros_like(y))
                x, y3, tr = alcg_mod.solve_traced(
                    self._solve_data, hits, params["ck"], b, curr_x, y2,
                    n_inner, x_star=x_star, err_denom=err_denom)
                return x, y3, act, tr["res"], (tr["err"] if x_star is not None else zero)
            x, tr = pcg_mod.solve_traced(
                self._solve_data.apply, self._solve_data.precondition(),
                b, curr_x, n_inner, x_star=x_star, err_denom=err_denom)
            return x, y, n_prev, tr["res"], (tr["err"] if x_star is not None else zero)

        global_jit = jax.jit(global_traced)
        rhs_jit = jax.jit(partial(sysm.rhs, system))

        res_rows, err_rows = [], []
        b = None
        overflow = False
        for _ in range(s.admm_iters):
            z, u = local_fn(system, curr_x, z, u)
            hits = detect_fn(obstacles, colliders, curr_x, self._surf_inds_dev)
            overflow |= bool(hits.overflow)
            b = rhs_jit(M_xbar, z, u)
            curr_x, y, n_prev, res, err = global_jit(b, curr_x, hits, y, n_prev)
            res_rows.append(np.asarray(res))
            err_rows.append(np.asarray(err))

        v_new = (curr_x - x0) * (1.0 / dt)
        self.state = sysm.SimState(x=curr_x, v=v_new, y=y, prev_active=n_prev)
        self._runtime = RuntimeData(collision_overflow=overflow)
        if overflow:
            print("**Solver::step_logged Warning: collision capacity "
                  "overflow — contacts were dropped this step (raise "
                  "HIT_CAP/cell_cap).")
        # The residual of the LAST inner iteration of the LAST solve, in
        # the active mode's own residual definition (see InnerLog): for
        # ls=1/2/4 the solved operator is penalty/Schur-augmented, so
        # ||A x - b|| on the bare operator would look non-converged even
        # when the solve is exact (ADVICE r2).
        final_r = float(res_rows[-1][-1]) if res_rows else 0.0
        self.solver_log = log_utils.InnerLog(
            residuals=np.stack(res_rows) if res_rows else np.zeros((0, n_inner)),
            errors=(np.stack(err_rows) if x_star is not None and err_rows else None),
            final_r=final_r,
            x_star=x_star_np,
        )
        return self.solver_log

    def run(self, n_steps: int):
        """Advance n_steps entirely on device (one dispatch, no per-step
        host sync). Equivalent to calling step() n_steps times with
        verbose=0; the hot path for benchmarking and batch sweeps."""
        assert self.initialized, "call initialize() first"
        s = self.m_settings
        t0 = time.perf_counter()
        new_state, overflow = _run_impl(
            self.system,
            self._solve_data,
            tuple(self.obstacles),
            tuple(self.colliders),
            tuple(self.ext_forces),
            self._surf_inds_dev,
            self._pin_mask,
            self._pin_target,
            self.state,
            self._params(),
            jnp.asarray(n_steps, jnp.int32),
            linsolver=s.linsolver,
            prox_iters=s.prox_newton_iters,
            with_passive=(s.linsolver != cfg.NCMCGS),
            refine_passes=self._refine_eff,
            unroll_admm_iters=(s.admm_iters if s.unroll_admm else 0),
            aa_window=s.aa_window,
            dense_surf=self._surf_dense,
        )
        self.state = jax.block_until_ready(new_state)
        self._runtime = RuntimeData(
            step_ms=(time.perf_counter() - t0) * 1e3 / max(n_steps, 1),
            collision_overflow=bool(overflow),
        )
        if self._runtime.collision_overflow:
            print("**Solver::run Warning: collision capacity overflow — "
                  "contacts were dropped during the rollout (raise "
                  "HIT_CAP/cell_cap).")

    def save_matrix(self, filename: str):
        """Dump the single-component global matrix (src/Solver.cpp:264-269)."""
        A = assembly.assemble_dense(self.system)
        print(f"Saving matrix ({A.shape[0]}x{A.shape[1]}) to {filename}")
        np.savetxt(filename, A)
