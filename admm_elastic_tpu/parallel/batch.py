"""Scenario batching + device-mesh sharding of the simulation step.

The reference scales only via OpenMP threads on one node (SURVEY §2,
parallelism inventory). The scale axes here are:

- **scene axis**: independent scenes / parameter sweeps batched with vmap
  and sharded data-parallel over a `jax.sharding.Mesh` axis ("scene") —
  the BASELINE.json 1024-scenario sweep,
- **shard axis**: the flat vertex dimension sharded over a second mesh
  axis ("shard") for the global solve; XLA/GSPMD inserts the halo
  collectives for the element gathers and psums for the CG dot products.

Per-scene material sweeps reuse one topology: the ADMM weights scale as
w' = w * sqrt(stiffness_scale) (w^2 = k*V, src/TetEnergyTerm.cpp:47), so a
stiffness sweep is a per-scene rescale of the weight arrays; the
matrix-free PCG path re-derives its Jacobi preconditioner per scene.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from admm_elastic_tpu import config as cfg
from admm_elastic_tpu.system import system as sysm


def make_sim_mesh(n_scene: Optional[int] = None, n_shard: int = 1, devices=None) -> Mesh:
    """Build a (scene, shard) device mesh (defaults: all devices on scene)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_scene is None:
        n_scene = len(devices) // n_shard
    return Mesh(devices.reshape(n_scene, n_shard), axis_names=("scene", "shard"))


def _scale_system(system: sysm.System, scale):
    """Scale all element stiffnesses by `scale` (weights by sqrt(scale))."""
    sq = jnp.sqrt(scale)
    tets = tuple(dataclasses.replace(b, weight=b.weight * sq, mu=b.mu * scale,
                                     lam=b.lam * scale, kappa=b.kappa * scale)
                 for b in system.tets)
    tris = tuple(dataclasses.replace(b, weight=b.weight * sq, mu=b.mu * scale,
                                     lam=b.lam * scale)
                 for b in system.tris)
    return dataclasses.replace(system, tets=tets, tris=tris)


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """Per-scene dynamic state + sweep parameters. All leading dim S."""

    x: jax.Array  # [S, N, 3]
    v: jax.Array  # [S, N, 3]
    y: jax.Array  # [S, H2]
    prev_active: jax.Array  # bool [S, H2] previous active constraint rows
    stiffness_scale: jax.Array  # [S]
    gravity: jax.Array  # [S]
    # Sticky per-scene collision-capacity flag (ORed every step): a scene
    # that ever dropped a contact stays flagged for the whole rollout.
    overflow: jax.Array  # bool [S]


jax.tree_util.register_dataclass(
    ScenarioBatch,
    data_fields=("x", "v", "y", "prev_active", "stiffness_scale", "gravity", "overflow"),
    meta_fields=(),
)


def make_scenario_batch(solver, n_scenes: int, stiffness_scale=None, gravity=None,
                        jitter: float = 0.0, seed: int = 0) -> ScenarioBatch:
    """Replicate the solver's initial state S times (optionally jittered)."""
    st = solver.state
    dtype = st.x.dtype
    x = jnp.broadcast_to(st.x, (n_scenes,) + st.x.shape)
    if jitter > 0.0:
        key = jax.random.PRNGKey(seed)
        x = x + jitter * jax.random.normal(key, x.shape, dtype=dtype)
    if stiffness_scale is None:
        stiffness_scale = jnp.ones((n_scenes,), dtype=dtype)
    if gravity is None:
        gravity = jnp.full((n_scenes,), solver.m_settings.gravity, dtype=dtype)
    return ScenarioBatch(
        x=x,
        v=jnp.zeros_like(x),
        y=jnp.broadcast_to(st.y, (n_scenes,) + st.y.shape),
        prev_active=jnp.broadcast_to(st.prev_active, (n_scenes,) + st.prev_active.shape),
        stiffness_scale=jnp.asarray(stiffness_scale, dtype=dtype),
        gravity=jnp.asarray(gravity, dtype=dtype),
        overflow=jnp.zeros((n_scenes,), dtype=bool),
    )


def _debloat_for_throughput(solver, system):
    """Rebuild gather-path element batches when stencil padding is heavy.

    The flat stencil pads dead lanes (ops/stencil.py) — irrelevant for a
    single latency-bound scene, but in the BATCHED regime the prox is
    throughput-bound across every scene and pays the padding directly
    (measured on the benchmarks/scaling.py sweep — 40x5x5 beams, 30.6%
    dead lanes: rebuilding to the gather path lifted large-S total ADMM
    iters/s by roughly the padding fraction). Above 15% padding the
    gather path wins back the waste: small meshes' gathers are cheap.
    """
    import dataclasses as dc

    from admm_elastic_tpu.ops import reduction as red
    from admm_elastic_tpu.system import elements as el

    t_cap = sum(b.n for b in system.tets) + sum(b.n for b in system.tris)
    t_live = sum(b.n_real for b in system.tets) + sum(b.n_real for b in system.tris)
    if t_cap == 0 or (t_cap - t_live) / t_cap <= 0.15:
        return system
    n = system.n_verts
    tets = tuple(
        dc.replace(
            el.build_tet_batch(v, t, lame, model, off, dtype=solver._dtype,
                               kappa=kap, lattice_dims=None),
            gather_idx=jnp.asarray(red.build_gather_table(t, n)))
        for (v, t, lame, model, off, kap, dims, wrapf) in solver._tet_specs
    )
    tris = tuple(
        dc.replace(
            el.build_tri_batch(v, t, lame, off, dtype=solver._dtype,
                               detect_stencil=False),
            gather_idx=jnp.asarray(red.build_gather_table(t, n)))
        for (v, t, lame, off) in solver._tri_specs
    )
    return dataclasses.replace(system, tets=tets, tris=tris)


def make_batched_step(solver, mesh: Optional[Mesh] = None, donate: bool = True,
                      linsolver: Optional[int] = None,
                      uses_sweep: bool = True):
    """Build a jitted sharded step over a ScenarioBatch.

    Runs the solver's configured global mode (or an explicit `linsolver`
    override) on the shardable ELL operator — PCG (ls=3), AL-PCG hard
    contact (ls=4), or Uzawa with the sparse PCG inner (ls=2); none needs
    a per-scene dense factor. The dense/GS modes (ls=0/1) have no
    per-scene-scalable operator and raise. Returns ScenarioBatch ->
    ScenarioBatch.
    """
    from admm_elastic_tpu.solver import _step_core
    from admm_elastic_tpu.solvers import pcg as pcg_mod

    ls = solver.m_settings.linsolver if linsolver is None else linsolver
    if ls not in (cfg.PCG, cfg.ALPCG, cfg.UZAWACG):
        raise ValueError(
            f"make_batched_step supports linsolver 3 (PCG), 4 (AL-PCG) and "
            f"2 (Uzawa, sparse inner); got {ls}. Re-initialize with one of "
            f"those or pass linsolver= explicitly."
        )
    system = solver.system
    system = _debloat_for_throughput(solver, system)
    # Base ELL form of A (unscaled); a per-scene stiffness sweep rescales
    # its stiffness entries (w^2 scales linearly, src/TetEnergyTerm.cpp:47).
    # Swept batches force Jacobi: the Jacobi diagonal rescales exactly per
    # scene, while a two-grid coarse inverse is built for ONE operator —
    # under a sweep it would precondition A(scale) with A(1)'s coarse solve
    # and convergence would quietly degrade toward the iteration cap.
    # Callers whose batches keep stiffness_scale == 1.0 everywhere pass
    # uses_sweep=False to keep the configured preconditioner (ADVICE r2:
    # an unconditional downgrade silently regressed unswept twogrid runs).
    precond = solver.m_settings.pcg_precond
    if uses_sweep and precond != "jacobi":
        import warnings

        warnings.warn(
            "make_batched_step uses the Jacobi preconditioner for swept "
            "scenes (the two-grid coarse inverse cannot follow a per-scene "
            "stiffness rescale); pass uses_sweep=False if every scene's "
            "stiffness_scale is 1.0.", stacklevel=2)
        precond = "jacobi"
    base_pcg = pcg_mod.prepare(system, solver._dtype, precond=precond)
    base_params = solver._params()
    obstacles = tuple(solver.obstacles)
    colliders = tuple(solver.colliders)
    winds = tuple(solver.ext_forces)
    surf = solver._surf_inds_dev
    pin_mask = solver._pin_mask
    pin_target = solver._pin_target
    prox_iters = solver.m_settings.prox_newton_iters

    def one(x, v, y, na, scale, grav):
        sys_s = _scale_system(system, scale)
        pcg_s = dataclasses.replace(
            base_pcg,
            ell_vals=base_pcg.ell_vals * scale,
            diag_stiff=base_pcg.diag_stiff * scale,
            # All off-diagonal entries are stiffness; the banded fast
            # path must follow the sweep exactly like the rest-ELL.
            bands=(None if base_pcg.bands is None
                   else base_pcg.bands * scale),
        )
        params = dict(base_params)
        params["gravity"] = grav
        if ls == cfg.ALPCG:
            # Penalty rows track the stiffest ADMM weight: the row factor
            # is sqrt(3 max_w) and max_w scales as sqrt(stiffness scale),
            # so ck follows scale**0.25 (ck^2 = 3 max_w sqrt(scale)).
            params["ck"] = base_params["ck"] * scale ** 0.25
        state = sysm.SimState(x=x, v=v, y=y, prev_active=na)
        new_state, _, ovf = _step_core(
            sys_s, pcg_s, obstacles, colliders, winds, surf, pin_mask, pin_target,
            state, params,
            linsolver=ls, prox_iters=prox_iters, with_passive=True,
            dense_surf=getattr(solver, "_surf_dense", False),
        )
        return new_state.x, new_state.v, new_state.y, new_state.prev_active, ovf

    def step(batch: ScenarioBatch) -> ScenarioBatch:
        x, v, y, na, ovf = jax.vmap(one)(
            batch.x, batch.v, batch.y, batch.prev_active,
            batch.stiffness_scale, batch.gravity,
        )
        return dataclasses.replace(batch, x=x, v=v, y=y, prev_active=na,
                                   overflow=batch.overflow | ovf)

    if mesh is None:
        return jax.jit(step, donate_argnums=(0,) if donate else ())

    # The vertex dimension can only be sharded when divisible by the shard
    # axis; otherwise fall back to scene-only sharding for x/v — loudly,
    # because a user who asked for a shard axis should know it is inactive
    # (pad the mesh or pick N % n_shard == 0 to engage it).
    n_verts = solver._n_verts
    n_shard = mesh.shape.get("shard", 1)
    if n_verts % max(n_shard, 1) == 0:
        xv_spec = P("scene", "shard", None)
    else:
        if n_shard > 1:
            import warnings

            warnings.warn(
                f"mesh shard axis has {n_shard} devices but n_verts="
                f"{n_verts} is not divisible; falling back to scene-only "
                f"sharding (vertex dim replicated).",
                stacklevel=2,
            )
        xv_spec = P("scene", None, None)
    state_sharding = ScenarioBatch(
        x=NamedSharding(mesh, xv_spec),
        v=NamedSharding(mesh, xv_spec),
        y=NamedSharding(mesh, P("scene")),
        prev_active=NamedSharding(mesh, P("scene")),
        stiffness_scale=NamedSharding(mesh, P("scene")),
        gravity=NamedSharding(mesh, P("scene")),
        overflow=NamedSharding(mesh, P("scene")),
    )
    # Scenes are independent: each device steps only its own scenes
    # (manual over "scene", no collective). The vertex axis, when sharded,
    # stays with the SPMD partitioner (auto over "shard"); the fused local
    # step kernel splits itself over it (ops/pallas_kernels.py).
    n_scene = mesh.shape["scene"]
    local_step = jax.shard_map(step, mesh=mesh, in_specs=P("scene"),
                               out_specs=P("scene"), axis_names={"scene"},
                               check_vma=False)

    def sharded(batch: ScenarioBatch) -> ScenarioBatch:
        if batch.x.shape[0] % n_scene:
            raise ValueError(
                f"{batch.x.shape[0]} scenes cannot be split evenly over the "
                f"mesh's {n_scene}-device scene axis")
        return local_step(batch)

    return jax.jit(
        sharded,
        in_shardings=(state_sharding,),
        out_shardings=state_sharding,
        donate_argnums=(0,) if donate else (),
    )
