"""Solver settings and CLI parsing.

Mirrors the reference ``Solver::Settings`` POD and its hand-rolled argv
parser (reference: src/Solver.hpp:39-50, src/Solver.cpp:273-307) with the
same flags and defaults, plus extension knobs (dtype, solver tolerances).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Linear solver ids (reference: src/Solver.hpp:47, `-ls <int>`)
LDLT = 0  # prefactored direct solve (no collisions allowed)
NCMCGS = 1  # nodal-constrained multicolor Gauss-Seidel
UZAWACG = 2  # Uzawa saddle-point CG
PCG = 3  # extension: matrix-free Jacobi-preconditioned CG (scalable)
ALPCG = 4  # extension: augmented-Lagrangian PCG hard contact (scalable)


@dataclasses.dataclass
class Settings:
    """Simulation settings.

    Defaults match the reference (src/Solver.hpp:48-49): dt=1/24 s,
    verbose=1, admm_iters=10, gravity=-9.8, linsolver=0 (direct),
    constraint_w=-1 (auto).
    """

    timestep_s: float = 1.0 / 24.0  # -dt
    verbose: int = 1  # -v
    admm_iters: int = 10  # -it
    gravity: float = -9.8  # -g
    linsolver: int = LDLT  # -ls (0=direct, 1=NCMCGS, 2=UzawaCG, 3=PCG)
    constraint_w: float = -1.0  # -ck (-1 = auto)

    # --- extensions (not in the reference CLI) ---
    dtype: Optional[np.dtype] = None  # None -> f64 if jax_enable_x64 else f32
    # Inner-solver iteration caps / tolerances. Reference values:
    # NCMCGS: 30 iters, tol 1e-10, omega 1.9 (src/NodalMultiColorGS.hpp:41-46)
    # UzawaCG: 20 iters, tol 1e-10 (src/UzawaCG.hpp:39-47)
    gs_max_iters: int = 30
    gs_tol: float = 1e-10
    gs_omega: float = 1.9
    uzawa_max_iters: int = 20
    uzawa_tol: float = 1e-10
    # Uzawa inner A^-1 operator. The reference prefactors sparse A with
    # SimplicialLDLT so UzawaCG scales to any mesh (src/LinearSolver.hpp:
    # 79-84, src/UzawaCG.hpp:92-120 needs only A^-1 applies); our dense
    # equilibrated inverse is one dense matrix product per apply for medium N
    # but O(N^2) memory. "auto" = dense below uzawa_dense_max_verts,
    # sparse ELL-PCG (two-grid preconditioned, bounded inner iterations)
    # above; "direct"/"pcg" force a mode. Explicit "pcg" uses the
    # pcg_precond setting; "auto" always picks "twogrid" for the inner
    # operator since each Schur iteration pays a full inner solve.
    uzawa_inner: str = "auto"
    uzawa_dense_max_verts: int = 8192
    # Above this vertex count linsolver=0 auto-switches to the ELL-PCG
    # path at direct-solve accuracy (tol 1e-10 clamp) instead of building
    # the dense N x N factor (12k verts = 1.2 GB host f64 + 0.6 GB device;
    # the reference's SimplicialLDLT is O(nnz) and has no such cliff,
    # src/LinearSolver.hpp:79-84). Raise to force dense.
    direct_max_verts: int = 12000
    uzawa_inner_tol: float = 1e-8
    uzawa_inner_iters: int = 200
    pcg_max_iters: int = 200
    pcg_tol: float = 1e-10
    # PCG preconditioner: "jacobi" (diagonal) or "twogrid" (aggregation
    # coarse level + damped-Jacobi smoothing; bounded iteration counts as
    # the mesh grows — prefer it for >~50k-vertex meshes or tight tols).
    pcg_precond: str = "jacobi"
    # Direct solver application mode: "inv" = precomputed A^-1 as one
    # matrix product per solve (default), "cho" = two batched
    # triangular solves. "inv" is also the robust default because XLA:CPU
    # miscompiles the triangular-solve custom call inside while_loop bodies
    # (observed with jax 0.9.0: results corrupt from the 3rd iteration on;
    # see tests/test_lineartet.py history), which "cho" would hit under the
    # jitted ADMM loop.
    direct_mode: str = "inv"
    # Fixed iteration count for the batched Newton solve inside the
    # hyperelastic prox (replaces the reference's per-element L-BFGS line
    # search, src/TetEnergyTerm.cpp:133).
    prox_newton_iters: int = 8
    # Anderson acceleration window m for the ADMM fixed point (0 = off).
    # Safeguarded type-II AA on the Douglas-Rachford variable v = Dx + u
    # (Peng et al. 2018, "Anderson Acceleration for Geometry Optimization
    # and Physics Simulation"). Measured on the NH beam (r3, f64): in the
    # practical 10-30 ADMM-iteration regime aa_window=4 cuts the error vs
    # the converged step by 5-14x (tests/test_anderson.py
    # test_aa_wins_on_elastic_scene, DESIGN.md); past ~100 iterations both
    # variants sit at the ADMM noise floor, so AA is neutral there. Cost
    # per iteration is a few [m, L] dots — negligible next to the global
    # solve. Off by default only for exact reference parity of iterates.
    # aa_safeguard is the allowed residual growth before falling back to
    # the plain iterate.
    aa_window: int = 0
    aa_safeguard: float = 1.0
    # SolverLog-tier convergence instrumentation (reference SolverLog,
    # src/SolverLog.hpp:36-64, hooked into every LinearSolver). When True,
    # step() routes through step_logged(): every global solve runs a
    # fixed-length traced variant (no early exit) and the per-inner-
    # iteration residual curves land in solver.solver_log
    # (utils/logging.InnerLog). Set solver.solver_log.x_star to also get
    # normalized error-vs-known-solution curves like the reference.
    log_inner: bool = False
    # Inner iterations recorded per global solve when log_inner is on
    # (0 = the configured max iters of the active solver).
    log_inner_iters: int = 0
    # Statically unroll the ADMM loop (admm_iters becomes compile-time):
    # XLA pipelines across iterations, ~35% lower per-iteration overhead at
    # ~5k-element scale, at the cost of admm_iters-x compile time.
    unroll_admm: bool = False
    # Iterative-refinement passes after each prefactored direct solve
    # (direct_mode="inv"). Each pass costs one matrix-free A apply + one
    # extra solve (~55% of the per-iteration time at bench scale). The
    # f32 solve error concentrates on the stiff pin rows, but those are
    # fixed by the always-on pin-row Jacobi polish (solvers/direct.polish,
    # measured pin deviation 1e-5 vs 2.4e-2 raw, ~20x cheaper than a
    # refinement pass); free-field error is f32-prox-noise-dominated, so
    # refinement is off by default. Raise for tight-tolerance runs.
    refine_passes: int = 0

    def parse_args(self, argv) -> bool:
        """Parse CLI flags; returns True if -help was requested.

        Same contract as the reference parser (src/Solver.cpp:273-307).
        """
        i = 0
        args = list(argv)
        n = len(args)
        known = ("-dt", "-v", "-it", "-g", "-ls", "-ck")
        while i < n:
            a = args[i]
            if a in ("-help", "--help", "-h"):
                self.help()
                return True
            if a in known:
                if i + 1 >= n:
                    # A trailing flag with no value is an input error, not
                    # something to swallow silently (round-1 ADVICE).
                    raise ValueError(
                        f"**Settings::parse_args Error: flag {a} needs a value."
                    )
                val = args[i + 1]
                if a == "-dt":
                    self.timestep_s = float(val)
                elif a == "-v":
                    self.verbose = int(val)
                elif a == "-it":
                    self.admm_iters = int(val)
                elif a == "-g":
                    self.gravity = float(val)
                elif a == "-ls":
                    self.linsolver = int(val)
                elif a == "-ck":
                    self.constraint_w = float(val)
                i += 1
            i += 1
        return False

    @staticmethod
    def help():
        print(
            "\n==========================================\nArgs:\n"
            "\t-dt: time step (s)\n"
            "\t-v: verbosity (higher -> show more)\n"
            "\t-it: # admm iters\n"
            "\t-g: gravity (m/s^2)\n"
            "\t-ls: linear solver (0=direct, 1=NCMCGS, 2=UzawaCG, 3=PCG, 4=AL-PCG contact)\n"
            "\t-ck: constraint weights (-1 = auto)\n"
            "=========================================="
        )


def default_dtype():
    """f64 when jax_enable_x64 is on (parity testing), else f32 (the device fast path)."""
    import jax

    return np.float64 if jax.config.jax_enable_x64 else np.float32


def resolve_dtype(settings: Settings):
    return np.dtype(settings.dtype) if settings.dtype is not None else np.dtype(default_dtype())
