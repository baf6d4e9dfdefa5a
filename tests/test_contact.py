"""Contact and constrained global solvers (reference M4/M5 scope).

Scenarios distilled from the tvcg2017 demos: floor contact with the
constrained Gauss-Seidel (signorini/boxes, linsolver=1) and with Uzawa
(torus, linsolver=2); PCG (ls=3) must match the direct solver on an
unconstrained problem; self-collision detection oracle.
"""

import numpy as np
import jax.numpy as jnp

from admm_elastic_tpu import Floor, Lame, Settings, Solver
from admm_elastic_tpu import binding
from admm_elastic_tpu.collision.dynamic import detect_dynamic, make_tet_mesh_collider
from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform

VERTS = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
TET = np.array([[0, 1, 2, 3]])

# The contact model resolves penetration each ADMM iteration against the
# *current* penetrating depth (constraints release when the vertex reaches
# the plane), so a resting object flip-flops within ~ one gravity kick
# (dt^2 * g ~ 0.017 m) of the floor — the reference shows the same bounded
# oscillation (verified: benchmarks/ref_driver with a floor settles to
# miny in [-0.767, -0.75] for floor at -0.75).
FLOOR_TOL = 0.05


def drop_box_solver(linsolver, floor_y=-0.75, admm_iters=10):
    """The reference driver's floor scene: unit cube (5 tets), rubber
    density lumped masses, soft-rubber material."""
    from admm_elastic_tpu.geometry.factory import make_tet_blocks
    from admm_elastic_tpu.geometry.mesh import lumped_masses_tet

    mesh = make_tet_blocks(1, 1, 1)
    solver = Solver()
    m = lumped_masses_tet(mesh.vertices, mesh.tets, 1522.0)
    solver.add_nodes(mesh.vertices, m)
    solver.add_tet_energies(
        mesh.vertices, mesh.tets, Lame.from_youngs_poisson(10000000, 0.399)
    )
    solver.add_obstacle(Floor(y=jnp.asarray(floor_y)))
    settings = Settings(verbose=0, admm_iters=admm_iters, linsolver=linsolver)
    assert solver.initialize(settings)
    return solver


def _check_settled(solver, floor_y=-0.75):
    x = solver.x
    assert np.isfinite(x).all()
    assert x[:, 1].min() > floor_y - FLOOR_TOL, x[:, 1].min()
    assert x[:, 1].min() < floor_y + 0.05  # resting at the floor
    # Cube top stays ~1 m above its bottom (no collapse/launch).
    assert 0.8 < x[:, 1].max() - x[:, 1].min() < 1.2


def test_floor_contact_gs():
    solver = drop_box_solver(linsolver=1)
    for _ in range(40):
        solver.step()
    _check_settled(solver)


def test_floor_contact_uzawa():
    solver = drop_box_solver(linsolver=2)
    for _ in range(40):
        solver.step()
    _check_settled(solver)


def test_uzawa_sparse_inner_matches_dense():
    """Uzawa with the sparse ELL-PCG inner operator (uzawa_inner="pcg",
    the O(nnz) path for meshes where dense N x N cannot exist) must track
    the dense prefactored inner on the same contact scene."""
    solvers = {}
    for inner in ("direct", "pcg"):
        solver = drop_box_solver(linsolver=2)
        solver.m_settings.uzawa_inner = inner
        solver.m_settings.uzawa_inner_tol = 1e-12
        assert solver.initialize(solver.m_settings)
        solvers[inner] = solver
    # Freefall + approach: the solves must agree tightly (measured
    # ~1e-13 over the first 8 steps). From contact ONSET (step 8 in this
    # scene) the constraint-activation boundary amplifies any difference
    # chaotically — a single reassociation-level perturbation can flip
    # which iteration first activates a row, giving O(dt^2 g) divergence
    # (the reference's bounded flip-flop, see FLOOR_TOL note) — so
    # trajectory equality stops being a meaningful oracle there; the
    # settle checks below carry the physics claim across the contact.
    for _ in range(8):
        for s in solvers.values():
            s.step()
        err = np.abs(solvers["direct"].x - solvers["pcg"].x).max()
        assert err < 1e-4, err
    # Both settle on the floor.
    for _ in range(32):
        for s in solvers.values():
            s.step()
    for s in solvers.values():
        _check_settled(s)


def test_ldlt_auto_switches_to_pcg_for_big_meshes(capsys):
    """linsolver=0 past direct_max_verts must not attempt the O(N^2)
    dense factor: it serves the solve through ELL-PCG at direct accuracy
    (the reference's sparse LDLT has no size cliff to mirror)."""
    from admm_elastic_tpu import binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks
    from admm_elastic_tpu.solvers.pcg import PCGData

    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    dense = Solver()
    binding.add_tetmesh(dense, mesh, Lame.soft_rubber(), verbose=False)
    dense.set_pins([0, 1])
    assert dense.initialize(Settings(verbose=0, admm_iters=8, linsolver=0))
    for _ in range(5):
        dense.step()

    auto = Solver()
    mesh2 = make_tet_blocks(4, 2, 2)
    mesh2.flags = binding.NOSELFCOLLISION | binding.LINEAR
    binding.add_tetmesh(auto, mesh2, Lame.soft_rubber(), verbose=False)
    auto.set_pins([0, 1])
    st = Settings(verbose=1, admm_iters=8, linsolver=0)
    st.direct_max_verts = 10  # scene has 45 verts -> triggers the switch
    assert auto.initialize(st)
    # The switch notice respects verbose (ADVICE r2): printed at >= 1 ...
    assert "ELL-PCG" in capsys.readouterr().out
    quiet = Solver()
    mesh3 = make_tet_blocks(4, 2, 2)
    mesh3.flags = binding.NOSELFCOLLISION | binding.LINEAR
    binding.add_tetmesh(quiet, mesh3, Lame.soft_rubber(), verbose=False)
    quiet.set_pins([0, 1])
    stq = Settings(verbose=0, admm_iters=8, linsolver=0)
    stq.direct_max_verts = 10
    assert quiet.initialize(stq)
    # ... and silent at 0, while the switch itself still happens.
    assert "ELL-PCG" not in capsys.readouterr().out
    assert isinstance(quiet._solve_data, PCGData)
    assert isinstance(auto._solve_data, PCGData)
    # The caller's Settings object is NOT mutated (Settings reuse across
    # solvers is normal); the override lives on the solver's private copy.
    assert st.linsolver == 0
    assert auto.m_settings.linsolver == 3
    for _ in range(5):
        auto.step()
    np.testing.assert_allclose(auto.x, dense.x, atol=1e-7, rtol=0)


def test_ldlt_big_mesh_with_obstacles_still_raises():
    """The size-based auto-switch must not bypass the reference's
    no-collisions-with-LDLT contract (src/Solver.cpp:249-254): silently
    serving the scene through PCG would ignore the obstacles entirely."""
    import pytest

    from admm_elastic_tpu import binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    s = Solver()
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.add_obstacle(Floor(y=jnp.asarray(-1.0)))
    st = Settings(verbose=0, linsolver=0)
    st.direct_max_verts = 10  # would trigger the auto-switch
    with pytest.raises(RuntimeError, match="No collisions with LDLT"):
        s.initialize(st)


def test_uzawa_auto_picks_sparse_for_big_meshes():
    """The auto threshold must route big meshes to the O(nnz) inner."""
    from admm_elastic_tpu.solvers.pcg import PCGData

    solver = drop_box_solver(linsolver=2)
    solver.m_settings.uzawa_dense_max_verts = 4  # cube has 8 verts
    assert solver.initialize(solver.m_settings)
    assert isinstance(solver._solve_data, PCGData)
    assert solver._solve_data.coarse_inv is not None  # auto -> twogrid
    for _ in range(40):
        solver.step()
    _check_settled(solver)


def test_floor_contact_alpcg():
    """The AL-PCG hard-contact mode (ls=4) must settle on the
    floor like GS/Uzawa; pre-contact it tracks GS to roundoff (same A, b)."""
    solver = drop_box_solver(linsolver=4)
    gs = drop_box_solver(linsolver=1)
    for _ in range(8):  # freefall: identical unconstrained solves
        solver.step()
        gs.step()
    assert np.abs(solver.x - gs.x).max() < 1e-10
    for _ in range(32):
        solver.step()
    _check_settled(solver)


def test_boxes_stack_alpcg():
    """AL-PCG handles dynamic (self-collision) constraint rows too: the
    stacked-boxes scene must not tunnel (same oracle as the GS version)."""
    solver = Solver()
    n_per = None
    for i in range(2):
        m = make_tet_blocks(3, 3, 3, cell=1.0 / 3.0)
        m.apply_xform(make_xform(trans=(0.0, i * 1.25, 0.0)))
        m.flags = binding.LINEAR
        binding.add_tetmesh(solver, m, Lame.rubber(), verbose=False)
        n_per = len(m.vertices)
    solver.add_obstacle(Floor(y=jnp.asarray(-0.5)))
    s = Settings(verbose=0, admm_iters=10, linsolver=4)
    assert solver.initialize(s)
    for _ in range(50):
        solver.step()
    x = solver.x
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -0.5 - FLOOR_TOL
    top_min = x[n_per:, 1].min()
    assert top_min > 0.2, top_min


def test_pcg_matches_direct():
    results = {}
    for ls in (0, 3):
        solver = Solver()
        solver.add_nodes(VERTS, np.ones(4))
        solver.add_tet_energies(VERTS, TET, Lame.from_youngs_poisson(5e5, 0.25))
        solver.set_pins([0])
        s = Settings(verbose=0, admm_iters=15, linsolver=ls, gravity=-9.8)
        assert solver.initialize(s)
        for _ in range(5):
            solver.step()
        results[ls] = solver.x
    assert np.abs(results[0] - results[3]).max() < 1e-7


def test_gs_matches_direct_unconstrained():
    """Without contacts/pins GS must converge to the same solution as the
    prefactored solve (same A, same b)."""
    results = {}
    for ls in (0, 1):
        solver = Solver()
        solver.add_nodes(VERTS, np.ones(4))
        solver.add_tet_energies(VERTS, TET, Lame.from_youngs_poisson(5e5, 0.25))
        s = Settings(verbose=0, admm_iters=10, linsolver=ls, gravity=-9.8,
                     gs_max_iters=200, gs_tol=1e-12)
        assert solver.initialize(s)
        for _ in range(3):
            solver.step()
        results[ls] = solver.x
    assert np.abs(results[0] - results[1]).max() < 1e-6


def test_self_collision_detection():
    """Point-in-tet + rest-pose projection oracle: a vertex pushed inside
    a separate box mesh is detected with a sensible face/normal."""
    box = make_tet_blocks(1, 1, 1)  # unit cube, 5 tets, verts at offset 0
    collider = make_tet_mesh_collider(box.vertices, box.tets, box.faces, vert_offset=0)

    n_box = len(box.vertices)
    # Global scene: box verts + one extra query vertex inside the box.
    x = np.concatenate([box.vertices, [[0.5, 0.5, 0.9]]], axis=0)
    q_idx = jnp.asarray([n_box], dtype=jnp.int32)
    res = detect_dynamic(collider, jnp.asarray(x), jnp.asarray(x[-1:]), q_idx)
    assert bool(res["mask"][0])
    # Nearest surface is the top face (z=1): normal should be +-z dominant.
    n = np.asarray(res["normal"][0])
    assert abs(n[2]) > 0.9, n
    assert float(res["dx"][0]) < 0
    b = np.asarray(res["barys"][0])
    assert abs(b.sum() - 1.0) < 1e-6 and (b > -1e-9).all()

    # A vertex outside is not detected.
    res2 = detect_dynamic(
        collider, jnp.asarray(x), jnp.asarray([[0.5, 0.5, 1.5]]), q_idx
    )
    assert not bool(res2["mask"][0])

    # A vertex of the box itself is not detected against its own tets.
    res3 = detect_dynamic(
        collider, jnp.asarray(x), jnp.asarray(box.vertices[:1]), jnp.asarray([0], dtype=jnp.int32)
    )
    assert not bool(res3["mask"][0])


def test_hit_cap_overflow_is_surfaced(capsys):
    """A deliberately folded mesh must trip the HIT_CAP compaction flag and
    surface it through step() -> RuntimeData.collision_overflow + warning
    (VERDICT r1: "no path where a dropped contact is invisible")."""
    import admm_elastic_tpu.collision.dynamic as dyn

    solver = Solver()
    meshes = []
    for i in range(2):
        m = make_tet_blocks(2, 2, 2, cell=0.5)
        m.apply_xform(make_xform(trans=(0.0, i * 0.6, 0.0)))  # overlapping
        m.flags = binding.LINEAR
        binding.add_tetmesh(solver, m, Lame.rubber(), verbose=False)
        meshes.append(m)
    s = Settings(verbose=0, admm_iters=3, linsolver=1)
    assert solver.initialize(s)
    old = dyn.HIT_CAP
    try:
        dyn.HIT_CAP = 1  # force compaction overflow on >1 penetration
        solver.step()
    finally:
        dyn.HIT_CAP = old
    assert solver.runtime_data().collision_overflow
    assert "overflow" in capsys.readouterr().out
    # A clean config does not flag (re-init rebuilds, fresh jit trace via
    # the restored capacity).
    solver2 = drop_box_solver(linsolver=1)
    solver2.step()
    assert not solver2.runtime_data().collision_overflow


def test_boxes_stack_gs():
    """Two stacked boxes with self/mutual collision + floor, NCMCGS
    (samples/tvcg2017/boxes.cpp scenario, scaled down)."""
    solver = Solver()
    meshes = []
    n_per = None
    for i in range(2):
        # 3x3x3 blocks per unit cube: the demo's box768 is similarly fine
        # relative to its size; vertex-vs-tet contact needs a few elements
        # across the thickness to catch penetrations before the rest-pose
        # projection flips to the far surface.
        m = make_tet_blocks(3, 3, 3, cell=1.0 / 3.0)
        m.apply_xform(make_xform(trans=(0.0, i * 1.25, 0.0)))
        m.flags = binding.LINEAR
        meshes.append(m)
        binding.add_tetmesh(solver, m, Lame.rubber(), verbose=False)
        n_per = len(m.vertices)
    solver.add_obstacle(Floor(y=jnp.asarray(-0.5)))
    s = Settings(verbose=0, admm_iters=10, linsolver=1)
    assert solver.initialize(s)
    for _ in range(50):
        solver.step()
    x = solver.x
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -0.5 - FLOOR_TOL
    # Upper box stays above the lower one (no tunneling through).
    top_min = x[n_per:, 1].min()
    assert top_min > 0.2, top_min


def test_uzawa_floor_contact_f32():
    """f32 Uzawa must hold the floor (regression: an accelerator fusion bug
    zeroed Floor normals built with zeros().at[...,1].set(1.0) and bodies
    tunneled straight through; constant-broadcast normals fix it)."""
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import Floor
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    s = Solver()
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.add_obstacle(Floor(y=jnp.asarray(-1.0)))
    st = Settings(verbose=0, admm_iters=10, linsolver=2, dtype=np.float32,
                  direct_mode="inv")
    assert s.initialize(st)
    s.run(30)
    x = np.asarray(s.state.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -1.05, f"tunneled: min y {x[:, 1].min()}"


def test_floor_normal_is_constant_broadcast():
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu.collision.passive import Floor

    f = Floor(y=jnp.asarray(-1.0))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((7, 3)))
    _, _, n = f.signed_distance(x)
    assert np.allclose(np.asarray(n), [0.0, 1.0, 0.0])


def test_sphere_obstacle_rest():
    """Beam dropped on a large sphere comes to rest on its surface."""
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import Sphere
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform

    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    mesh.apply_xform(make_xform(trans=(-2.0, 2.0, -1.0)))
    s = Solver()
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    center = jnp.asarray([0.0, -10.0, 0.0])
    s.add_obstacle(Sphere(center=center, rad=jnp.asarray(10.0)))
    st = Settings(verbose=0, admm_iters=10, linsolver=1, gravity=-9.8)
    assert s.initialize(st)
    s.run(40)
    x = np.asarray(s.x)
    assert np.isfinite(x).all()
    d = np.linalg.norm(x - np.asarray(center), axis=1)
    assert d.min() > 10.0 - 0.05, f"penetrated sphere: min dist {d.min()}"
    assert d.min() < 10.2, "never touched the sphere"


def test_mesh_sdf_obstacle_rest():
    """Beam dropped onto a voxel-SDF box obstacle rests on top of it."""
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import PassiveMeshSDF
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform

    # Obstacle: unit box spanning [0,2]x[-1,0]x[0,2] (top face at y=0).
    obs = make_tet_blocks(4, 2, 4, cell=0.5)
    obs.apply_xform(make_xform(trans=(0.0, -1.0, 0.0)))
    sdf = PassiveMeshSDF.from_tet_mesh(obs.vertices, obs.tets, resolution=32)

    mesh = make_tet_blocks(3, 2, 2, cell=0.4)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    mesh.apply_xform(make_xform(trans=(0.4, 1.0, 0.4)))
    s = Solver()
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.add_obstacle(sdf)
    st = Settings(verbose=0, admm_iters=10, linsolver=1, gravity=-9.8)
    assert s.initialize(st)
    s.run(40)
    x = np.asarray(s.x)
    assert np.isfinite(x).all()
    # Beam footprint is above the box: resting height ~ y=0 (voxel blur
    # allows a small tolerance).
    assert x[:, 1].min() > -0.15, f"sank into SDF box: min y {x[:, 1].min()}"
    assert x[:, 1].min() < 0.15, "hovering above the box"


def test_mesh_exact_obstacle_oracle():
    """PassiveMeshExact vs a brute-force all-triangles/all-tets oracle.

    The exact narrow phase (reference PassiveMesh semantics,
    src/PassiveObject.hpp:67-107: point-in-tet inside test +
    nearest-surface-triangle projection) must agree with an O(P*F)
    exhaustive evaluation bit-for-bit wherever the query is within the
    grid's capture radius: same signed distance, a projection point at
    exactly |dx| from the query, and an outward normal.
    """
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu.collision.passive import (
        PassiveMeshExact, _point_tri_distance_np, _points_in_tets_np)
    from admm_elastic_tpu.geometry.factory import make_tet_blocks
    from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets

    obs = make_tet_blocks(4, 2, 4, cell=0.25)
    m = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=16)

    rng = np.random.default_rng(0)
    lo = obs.vertices.min(0) - 0.05
    hi = obs.vertices.max(0) + 0.05
    pts = rng.uniform(lo, hi, size=(2000, 3))
    faces = surface_faces_from_tets(obs.tets)
    d_ref = _point_tri_distance_np(pts, obs.vertices, faces)
    ins_ref = _points_in_tets_np(pts, obs.vertices, obs.tets)
    sd_ref = np.where(ins_ref, -d_ref, d_ref)

    dx, point, normal = (np.asarray(v) for v in m.signed_distance(jnp.asarray(pts)))
    # capture radius = 2 cells; h = max extent / 16.
    near = np.abs(sd_ref) < 0.1
    assert near.sum() > 500
    assert np.abs(dx - sd_ref)[near].max() < 1e-12
    pn = np.linalg.norm(pts - point, axis=-1)
    assert np.abs(pn - np.abs(dx))[near].max() < 1e-12
    dots = ((pts - point) * normal).sum(-1) / np.maximum(pn, 1e-30)
    out = near & (sd_ref > 1e-6)
    inn = near & (sd_ref < -1e-6)
    assert dots[out].min() > 0.5, "normal not outward for outside points"
    assert dots[inn].max() < -0.5, "normal not outward for inside points"
    # Far-away points (outside the candidate grid) report no-hit.
    far = np.asarray(m.signed_distance(jnp.asarray(lo - 5.0))[0])
    assert far > 1e20


def test_mesh_exact_obstacle_rest():
    """Beam dropped onto an exact-mesh box obstacle rests ON its surface.

    Same scene as test_mesh_sdf_obstacle_rest but through the exact
    narrow phase: the resting tolerance tightens from the voxel blur
    (~0.15) to contact-solver resolution (~0.02).
    """
    import numpy as np

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import PassiveMeshExact
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform

    obs = make_tet_blocks(4, 2, 4, cell=0.5)
    obs.apply_xform(make_xform(trans=(0.0, -1.0, 0.0)))
    exact = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=24)

    mesh = make_tet_blocks(3, 2, 2, cell=0.4)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    mesh.apply_xform(make_xform(trans=(0.4, 1.0, 0.4)))
    s = Solver()
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.add_obstacle(exact)
    st = Settings(verbose=0, admm_iters=10, linsolver=1, gravity=-9.8)
    assert s.initialize(st)
    s.run(40)
    x = np.asarray(s.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -0.02, f"sank into exact box: min y {x[:, 1].min()}"
    assert x[:, 1].min() < 0.05, "hovering above the box"


def test_mesh_exact_deep_penetration_oracle():
    """Deep-penetration fallback vs the brute-force global-nearest oracle.

    Points deeper inside the solid than the grid's capture radius have no
    candidate triangle in their cell; the reference's BVH still projects
    them to the global nearest surface triangle at ANY depth
    (src/PassiveObject.hpp:85-91). The fallback must reproduce that:
    exact signed distance, projection at |dx|, inward-facing query ray.
    (Before r4 these lanes silently reported no-hit.)
    """
    import jax.numpy as jnp

    from admm_elastic_tpu.collision.passive import (
        PassiveMeshExact, _point_tri_distance_np)
    from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets

    obs = make_tet_blocks(4, 2, 4, cell=0.25)  # [0,1]x[0,0.5]x[0,1]
    m = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=16)
    capture = 2.0 * float(np.asarray(m.h))  # = 0.125

    rng = np.random.default_rng(1)
    # Mid-slab points: depth to every face >= 0.2 > capture radius.
    pts = rng.uniform([0.3, 0.2, 0.3], [0.7, 0.3, 0.7], size=(60, 3))
    faces = surface_faces_from_tets(obs.tets)
    d_ref = _point_tri_distance_np(pts, obs.vertices, faces)
    assert d_ref.min() > capture, "test points must exceed the capture radius"

    dx, point, normal = (np.asarray(v)
                         for v in m.signed_distance(jnp.asarray(pts)))
    assert (dx < 0).all(), "deep inside points must report penetration"
    assert np.abs(dx + d_ref).max() < 1e-12, "fallback distance != global nearest"
    pn = np.linalg.norm(pts - point, axis=-1)
    assert np.abs(pn - np.abs(dx)).max() < 1e-12
    dots = ((pts - point) * normal).sum(-1) / np.maximum(pn, 1e-30)
    assert dots.max() < -0.5, "normal must face outward (query is inside)"


def test_mesh_exact_deep_penetration_capacity():
    """More deep lanes than fallback capacity: extras degrade to the old
    no-hit semantics (never a wrong projection), the capacity's worth get
    exact answers."""
    import jax.numpy as jnp

    from admm_elastic_tpu.collision.passive import PassiveMeshExact

    obs = make_tet_blocks(4, 2, 4, cell=0.25)
    m = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=16,
                                       fallback_lanes=4)
    rng = np.random.default_rng(2)
    pts = rng.uniform([0.3, 0.2, 0.3], [0.7, 0.3, 0.7], size=(50, 3))
    dx = np.asarray(m.signed_distance(jnp.asarray(pts))[0])
    assert (dx < 0).sum() == 4, "exactly the fallback capacity projects"
    assert (dx[dx > 0] > 1e20).all(), "overflow lanes report no-hit"


def test_mesh_exact_deep_impact_restores():
    """A body slammed >2 capture radii into the slab in ONE step keeps its
    restoring constraint (pre-r4: silent no-hit exactly at the deepest
    moment) and is pushed back out instead of sinking through."""
    from admm_elastic_tpu.collision.passive import PassiveMeshExact

    # Slab [0,1.5]x[-0.5,0]x[0,1.5]; cells=24 -> h=0.0625, capture=0.125.
    obs = make_tet_blocks(6, 2, 6, cell=0.25)
    obs.apply_xform(make_xform(trans=(0.0, -0.5, 0.0)))
    exact = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=24,
                                           fallback_lanes=256)

    body = make_tet_blocks(2, 2, 2, cell=0.15)
    body.flags = binding.NOSELFCOLLISION | binding.LINEAR
    body.apply_xform(make_xform(trans=(0.6, 0.02, 0.6)))
    s = Solver()
    binding.add_tetmesh(s, body, Lame.soft_rubber(), verbose=False)
    s.add_obstacle(exact)
    st = Settings(verbose=0, admm_iters=10, linsolver=1, gravity=-9.8)
    assert s.initialize(st)
    # One step at dt=1/24 with v=-7 drives the bottom face ~0.29 deep:
    # more than twice the 0.125 capture radius, well inside the 0.5 slab.
    v0 = np.zeros_like(s.v)
    v0[:, 1] = -7.0
    s.v = v0
    s.step()
    x1 = np.asarray(s.x)
    assert np.isfinite(x1).all()
    # With no constraint the body would be at ~0.02 - 7/24 = -0.27; the
    # restoring projection must have recovered most of that in-step.
    assert x1[:, 1].min() > -0.15, f"no restoring constraint: {x1[:, 1].min()}"
    s.run(20)
    x = np.asarray(s.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > -0.05, f"sank through the slab: {x[:, 1].min()}"
    assert x[:, 1].min() < 0.1, "hovering above the slab"


def test_mesh_exact_nonconvex_sign_oracle():
    """Deep-band sign exactness on a NON-CONVEX obstacle (r5 fix).

    Candidate faces are captured by per-axis AABB inflation, so a point
    deeper inside than the capture radius can see ONLY a spurious
    diagonal-band candidate; pre-r5 any_face=True suppressed the deep
    fallback and signing against that wrong feature could misclassify an
    inside point as outside on non-convex meshes (the convex benchmark
    slabs never trip it — ADVICE r4). The fallback now also triggers
    when the nearest candidate exceeds the guaranteed-exact radius, and
    the sign is gated on tet-cell occupancy (an outside proof), so on a
    torus at a deliberately tight capture radius: every inside oracle
    point must report its exact global penetration, and no outside point
    may report a phantom hit.
    """
    from admm_elastic_tpu.collision.passive import (
        PassiveMeshExact, _point_tri_distance_np, _points_in_tets_np)
    from admm_elastic_tpu.geometry.factory import make_tet_torus
    from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets

    obs = make_tet_torus(major_radius=1.0, minor_radius=0.45,
                         n_ring=16, n_sec=4)
    faces = surface_faces_from_tets(obs.tets)
    rng = np.random.default_rng(5)
    lo = obs.vertices.min(0) - 0.05
    hi = obs.vertices.max(0) + 0.05
    pts = rng.uniform(lo, hi, size=(1500, 3))
    d_ref = _point_tri_distance_np(pts, obs.vertices, faces)
    ins_ref = _points_in_tets_np(pts, obs.vertices, obs.tets)
    sure = d_ref > 1e-6  # keep sign assertions away from roundoff ties

    for capture_cells in (1.0, 2.0):
        m = PassiveMeshExact.from_tet_mesh(
            obs.vertices, obs.tets, cells=20, capture_cells=capture_cells,
            fallback_lanes=2048)
        dx, point, normal, ovf = (np.asarray(v) for v in
            m.signed_distance_with_overflow(jnp.asarray(pts)))
        assert not bool(ovf)

        inn = ins_ref & sure
        assert inn.sum() > 100
        assert (dx[inn] < 0).all(), "inside point misclassified as outside"
        assert np.abs(dx[inn] + d_ref[inn]).max() < 1e-10, \
            "penetration depth != global nearest surface distance"
        out = ~ins_ref & sure
        assert (dx[out] >= 0).all(), "outside point reported a phantom hit"
        # In-capture outside distances match the global oracle too.
        near_out = out & (d_ref < capture_cells * float(np.asarray(m.h)))
        assert near_out.sum() > 50
        assert np.abs(dx[near_out] - d_ref[near_out]).max() < 1e-10


def test_mesh_exact_near_lane_compaction_matches_dense():
    """near_lanes compaction is contact-exact vs the dense narrow phase.

    Tier 1 only skips lanes whose grid cell holds NO candidate tet — a
    penetrating point is inside a tet and a point inside a tet always
    lies in a cell that tet's AABB overlaps, so those lanes provably
    have dx > 0. With enough capacity: every dense HIT (dx < 0) must be
    reproduced bit-for-bit (dx, point, normal), every reported lane must
    equal the dense answer, skipped lanes are exactly the provably
    non-penetrating ones, and overflow is False.
    """
    import dataclasses

    import jax.numpy as jnp

    from admm_elastic_tpu.collision.passive import PassiveMeshExact

    obs = make_tet_blocks(4, 2, 4, cell=0.25)
    dense = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=16)

    rng = np.random.default_rng(3)
    lo = obs.vertices.min(0)
    hi = obs.vertices.max(0)
    # Mix of near (in/around the slab) and far (outside the grid) points.
    pts = np.concatenate([
        rng.uniform(lo - 0.05, hi + 0.05, size=(500, 3)),
        rng.uniform(lo - 4.0, lo - 2.0, size=(500, 3)),
    ])
    rng.shuffle(pts)
    pts = jnp.asarray(pts)

    d0, p0, n0 = dense.signed_distance(pts)
    comp = dataclasses.replace(dense, near_lanes=600)
    d1, p1, n1, ovf = comp.signed_distance_with_overflow(pts)

    d0, p0, n0, d1, p1, n1 = map(np.asarray, (d0, p0, n0, d1, p1, n1))
    assert not bool(ovf)
    hit = d0 < 0
    assert hit.sum() > 100
    assert np.array_equal(d0[hit], d1[hit]), "a penetrating lane changed"
    assert np.array_equal(p0[hit], p1[hit])
    assert np.array_equal(n0[hit], n1[hit])
    reported = d1 < 1e20
    assert hit[~reported].sum() == 0, "compaction dropped a hit"
    assert np.array_equal(d0[reported], d1[reported]), \
        "a reported lane differs from dense"


def test_mesh_exact_near_lane_overflow_accounting():
    """Over-capacity compaction surfaces overflow and NEVER reports a
    wrong projection: reported lanes equal the dense answer exactly, the
    dropped lanes report no-hit (dx = big), and the solver path routes
    the flag into RuntimeData.collision_overflow."""
    import dataclasses

    import jax.numpy as jnp

    from admm_elastic_tpu.collision.passive import (PassiveMeshExact,
                                                    detect_passive)

    obs = make_tet_blocks(4, 2, 4, cell=0.25)
    dense = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=16)

    rng = np.random.default_rng(4)
    lo = obs.vertices.min(0)
    hi = obs.vertices.max(0)
    pts = jnp.asarray(rng.uniform(lo, hi, size=(256, 3)))  # all near

    comp = dataclasses.replace(dense, near_lanes=16)
    d0 = np.asarray(dense.signed_distance(pts)[0])
    d1, _, _, ovf = comp.signed_distance_with_overflow(pts)
    d1 = np.asarray(d1)
    assert bool(ovf), "dropping near lanes must surface overflow"
    reported = d1 < 1e20
    assert 0 < reported.sum() <= 16, "at most the capacity reports"
    assert np.array_equal(d1[reported], d0[reported]), \
        "reported lanes must still be exact"
    assert (d1[~reported] > 1e20).all(), "dropped lanes report no-hit"

    # detect_passive propagates the flag (solver merges it into
    # RuntimeData.collision_overflow like the dynamic-hit caps).
    *_, ovf2 = detect_passive([comp], pts)
    assert bool(ovf2)
    *_, ovf3 = detect_passive([dense], pts)
    assert not bool(ovf3)


def test_mesh_exact_near_lane_compaction_end_to_end():
    """The resting-beam scene through a compacted exact obstacle follows
    the dense-obstacle trajectory bit-for-bit (CPU f64, same program
    modulo the compaction tier) and raises no overflow."""
    import dataclasses

    from admm_elastic_tpu.collision.passive import PassiveMeshExact

    obs = make_tet_blocks(4, 2, 4, cell=0.5)
    obs.apply_xform(make_xform(trans=(0.0, -1.0, 0.0)))
    dense = PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=24)

    def run(exact):
        mesh = make_tet_blocks(3, 2, 2, cell=0.4)
        mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
        mesh.apply_xform(make_xform(trans=(0.4, 1.0, 0.4)))
        s = Solver()
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        s.add_obstacle(exact)
        st = Settings(verbose=0, admm_iters=10, linsolver=1, gravity=-9.8)
        assert s.initialize(st)
        s.run(25)
        return np.asarray(s.x), s.runtime_data().collision_overflow

    x_dense, _ = run(dense)
    x_comp, ovf = run(dataclasses.replace(dense, near_lanes=64))
    assert not ovf
    assert np.isfinite(x_comp).all()
    assert np.abs(x_comp - x_dense).max() < 1e-12, \
        "compacted obstacle changed the trajectory"
    assert x_comp[:, 1].min() > -0.02


def test_mesh_sdf_near_lane_compaction():
    """PassiveMeshSDF near_lanes compaction: tier 1 skips only lanes whose
    base corner sample proves the trilinear value positive (convex combo
    of 8 corners of a 1-Lipschitz SDF, pairwise <= sqrt(3)h apart), so
    every dense hit is reproduced bit-for-bit; over-capacity surfaces
    overflow and degrades extras to no-hit, never a wrong projection."""
    import dataclasses

    import jax.numpy as jnp

    from admm_elastic_tpu.collision.passive import (PassiveMeshSDF,
                                                    detect_passive)

    obs = make_tet_blocks(4, 2, 4, cell=0.25)
    dense = PassiveMeshSDF.from_tet_mesh(obs.vertices, obs.tets,
                                         resolution=24)

    rng = np.random.default_rng(5)
    lo = obs.vertices.min(0)
    hi = obs.vertices.max(0)
    pts = np.concatenate([
        rng.uniform(lo - 0.05, hi + 0.05, size=(500, 3)),
        rng.uniform(lo - 3.0, lo - 1.0, size=(500, 3)),
    ])
    rng.shuffle(pts)
    pts = jnp.asarray(pts)

    d0, p0, n0 = (np.asarray(v) for v in dense.signed_distance(pts))
    comp = dataclasses.replace(dense, near_lanes=700)
    d1, p1, n1, ovf = comp.signed_distance_with_overflow(pts)
    d1, p1, n1 = map(np.asarray, (d1, p1, n1))

    assert not bool(ovf)
    hit = d0 < 0
    assert hit.sum() > 100
    assert np.array_equal(d0[hit], d1[hit]), "a penetrating lane changed"
    assert np.array_equal(p0[hit], p1[hit])
    assert np.array_equal(n0[hit], n1[hit])
    reported = d1 < 1e20
    assert hit[~reported].sum() == 0, "compaction dropped a hit"
    assert np.array_equal(d0[reported], d1[reported])

    # Over-capacity: exact on the reported lanes, no-hit on the dropped
    # ones, overflow surfaced through detect_passive.
    tiny = dataclasses.replace(dense, near_lanes=8)
    inner = jnp.asarray(rng.uniform(lo + 0.1, hi - 0.1, size=(128, 3)))
    d2, _, _, ovf2 = tiny.signed_distance_with_overflow(inner)
    d2 = np.asarray(d2)
    d_ref = np.asarray(dense.signed_distance(inner)[0])
    assert bool(ovf2)
    rep = d2 < 1e20
    assert 0 < rep.sum() <= 8
    assert np.array_equal(d2[rep], d_ref[rep])
    *_, ovf3 = detect_passive([tiny], inner)
    assert bool(ovf3)
