"""Gather-free flat-stencil D/D^T for lattice meshes: detection + exactness.

The flat stencil (ops/stencil.py v2) reorders elements slot-major over
vertex-pitch-embedded cells and pads dead lanes; exactness is checked
against the gather path through the FlatPlan.src element map, and
end-to-end by trajectory equality of stencil vs forced-gather solvers.
"""

import numpy as np
import pytest

from admm_elastic_tpu.geometry.factory import make_tet_blocks
from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.ops import reduction as red
from admm_elastic_tpu.ops import stencil
from admm_elastic_tpu.system import elements as el


def test_verify_lattice_detects_and_rejects():
    mesh = make_tet_blocks(4, 3, 2)
    meta = stencil.verify_lattice(mesh.tets, mesh.lattice_dims)
    assert meta is not None
    base, X, Y, Z, pe, po, wrap = meta
    assert (base, X, Y, Z, wrap) == (0, 5, 4, 3, False)
    # Any permutation of tet order breaks the cell-major layout contract.
    rng = np.random.default_rng(0)
    assert stencil.verify_lattice(
        mesh.tets[rng.permutation(len(mesh.tets))], mesh.lattice_dims) is None
    # Wrong dims are rejected.
    assert stencil.verify_lattice(mesh.tets, (3, 4, 2)) is None


def _tet_batches(nx, ny, nz, off=0, n_extra=0, seed=1):
    """(flat-stencil batch, gather batch, plan, x, n_total) for one lattice."""
    mesh = make_tet_blocks(nx, ny, nz)
    lame = Lame.soft_rubber()
    flat = el.build_tet_batch(mesh.vertices, mesh.tets, lame, "neohookean",
                              vertex_offset=off, lattice_dims=mesh.lattice_dims)
    ref = el.build_tet_batch(mesh.vertices, mesh.tets, lame, "neohookean",
                             vertex_offset=off, lattice_dims=None)
    assert flat.stencil is not None and ref.stencil is None
    plan = stencil.tet_flat_plan(flat.stencil)
    n_total = off + len(mesh.vertices) + n_extra
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_total, 3))
    return flat, ref, plan, x, n_total


def test_flat_stencil_dx_matches_gather_and_injects_identity():
    import jax.numpy as jnp

    flat, ref, plan, x, _ = _tet_batches(5, 4, 3)
    xd = jnp.asarray(x)
    rows_flat = np.asarray(stencil.tet_Dx_rows(xd, flat))
    rows_ref = np.asarray(red.tet_Dx_rows(xd, ref.inds, ref.Dlocal))
    live = plan.src >= 0
    np.testing.assert_allclose(rows_flat[:, live], rows_ref[:, plan.src[live]],
                               rtol=1e-12, atol=1e-12)
    # Dead lanes carry an identity F (rows 0/4/8 = 1, rest 0).
    ident = np.zeros((9, int((~live).sum())))
    ident[[0, 4, 8]] = 1.0
    np.testing.assert_allclose(rows_flat[:, ~live], ident, atol=1e-15)


def test_flat_stencil_dt_matches_gather():
    import jax.numpy as jnp

    flat, ref, plan, x, n = _tet_batches(5, 4, 3)
    rng = np.random.default_rng(3)
    g_ref = rng.standard_normal((9, ref.n))
    g_flat = np.zeros((9, flat.n))
    live = plan.src >= 0
    g_flat[:, live] = g_ref[:, plan.src[live]]
    gi = jnp.asarray(red.build_gather_table(np.asarray(ref.inds), n))
    dt_ref = np.asarray(red.tet_Dt_rows(jnp.asarray(g_ref), ref.inds,
                                        ref.Dlocal, n, gi))
    dt_flat = np.asarray(stencil.tet_Dt_rows(jnp.asarray(g_flat), flat, n))
    np.testing.assert_allclose(dt_flat, dt_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dims,off", [((5, 4, 3), 0), ((4, 2, 2), 11)])
def test_flat_stencil_dx_matches_gather_at_lattice(dims, off):
    """D x at lattices with and without a vertex offset, incl. the
    identity F on every dead (padded) lane."""
    import jax.numpy as jnp

    flat, ref, plan, x, _ = _tet_batches(*dims, off=off, n_extra=3)
    xd = jnp.asarray(x)
    rows = np.asarray(stencil.tet_Dx_rows(xd, flat))
    live = plan.src >= 0
    np.testing.assert_allclose(
        rows[:, live],
        np.asarray(red.tet_Dx_rows(xd, ref.inds, ref.Dlocal))[:, plan.src[live]],
        rtol=1e-12, atol=1e-12)
    dead = rows[:, ~live]
    np.testing.assert_array_equal(dead[[0, 4, 8]], 1.0)
    np.testing.assert_array_equal(dead[[1, 2, 3, 5, 6, 7]], 0.0)


@pytest.mark.parametrize("dims,off", [((5, 4, 3), 0), ((4, 2, 2), 11)])
def test_flat_stencil_rhs_matches_gather_at_lattice(dims, off):
    """The rhs elastic term D^T W^2 (z - u) (src/Solver.cpp:98) through
    the stencil vs the gather path; dead lanes carry w^2 = 0."""
    import jax.numpy as jnp

    from admm_elastic_tpu.system import system as sysm

    flat, ref, plan, _, n = _tet_batches(*dims, off=off, n_extra=3)
    rng = np.random.default_rng(7)
    z_ref = rng.standard_normal((9, ref.n))
    u_ref = rng.standard_normal((9, ref.n))
    live = plan.src >= 0
    z_flat = rng.standard_normal((9, flat.n))  # dead lanes: arbitrary
    u_flat = rng.standard_normal((9, flat.n))
    z_flat[:, live] = z_ref[:, plan.src[live]]
    u_flat[:, live] = u_ref[:, plan.src[live]]
    got = np.asarray(sysm._tet_DtW2(flat, jnp.asarray(z_flat - u_flat), n))
    want = np.asarray(sysm._tet_DtW2(ref, jnp.asarray(z_ref - u_ref), n))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_flat_stencil_offset_family():
    """Second mesh staged at a vertex offset (boxes scene layout)."""
    import jax.numpy as jnp

    flat, ref, plan, x, n = _tet_batches(3, 2, 2, off=37, n_extra=11, seed=2)
    xd = jnp.asarray(x)
    live = plan.src >= 0
    np.testing.assert_allclose(
        np.asarray(stencil.tet_Dx_rows(xd, flat))[:, live],
        np.asarray(red.tet_Dx_rows(xd, ref.inds, ref.Dlocal))[:, plan.src[live]],
        rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(4)
    g_ref = rng.standard_normal((9, ref.n))
    g_flat = np.zeros((9, flat.n))
    g_flat[:, live] = g_ref[:, plan.src[live]]
    np.testing.assert_allclose(
        np.asarray(stencil.tet_Dt_rows(jnp.asarray(g_flat), flat, n)),
        np.asarray(red.tet_Dt_rows(jnp.asarray(g_ref), ref.inds,
                                   ref.Dlocal, n)),
        rtol=1e-12, atol=1e-12)


def test_flat_stencil_weights_dead_on_padded_lanes():
    flat, ref, plan, _, _ = _tet_batches(4, 3, 2)
    live = plan.src >= 0
    w = np.asarray(flat.weight)
    v = np.asarray(flat.vol)
    assert (w[~live] == 0).all() and (v[~live] == 0).all()
    assert (w[live] > 0).all()
    assert flat.n_real == ref.n and flat.n == plan.t_cap


def test_ring_stencil_torus_matches_gather():
    """Periodic (wrap) lattice: torus D/D^T equals the gather path."""
    import jax.numpy as jnp

    from admm_elastic_tpu.geometry.factory import make_tet_torus

    mesh = make_tet_torus(n_ring=10, n_sec=4)
    lame = Lame.soft_rubber()
    flat = el.build_tet_batch(mesh.vertices, mesh.tets, lame, "neohookean",
                              lattice_dims=mesh.lattice_dims,
                              lattice_wrap=True)
    ref = el.build_tet_batch(mesh.vertices, mesh.tets, lame, "neohookean")
    assert flat.stencil is not None and flat.stencil[6] is True
    plan = stencil.tet_flat_plan(flat.stencil)
    n = len(mesh.vertices)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((n, 3)))
    live = plan.src >= 0

    rows_flat = np.asarray(stencil.tet_Dx_rows(x, flat))
    rows_ref = np.asarray(red.tet_Dx_rows(x, ref.inds, ref.Dlocal))
    np.testing.assert_allclose(rows_flat[:, live], rows_ref[:, plan.src[live]],
                               rtol=1e-12, atol=1e-12)

    g_ref = rng.standard_normal((9, ref.n))
    g_flat = np.zeros((9, flat.n))
    g_flat[:, live] = g_ref[:, plan.src[live]]
    np.testing.assert_allclose(
        np.asarray(stencil.tet_Dt_rows(jnp.asarray(g_flat), flat, n)),
        np.asarray(red.tet_Dt_rows(jnp.asarray(g_ref), ref.inds,
                                   ref.Dlocal, n)),
        rtol=1e-12, atol=1e-12)
    # The wrap seam really is exercised: some live corner reads cross it.
    base, X, Y, Z, pe, po, wrap = flat.stencil
    assert wrap
    ii = np.asarray(mesh.tets) // (Y * Z)
    assert (ii.max(axis=1) - ii.min(axis=1) > 1).any()


def test_ring_stencil_full_step_trajectory_matches(monkeypatch):
    """End-to-end torus: ring stencil vs forced gather path."""
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_torus

    def run(use_stencil, monkeypatch):
        if not use_stencil:
            monkeypatch.setenv("ADMM_NO_STENCIL", "1")
        else:
            monkeypatch.delenv("ADMM_NO_STENCIL", raising=False)
        mesh = make_tet_torus(n_ring=10, n_sec=4)
        mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
        s = Solver()
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        n_cs = (4 + 1) ** 2
        s.set_pins(list(range(n_cs)))  # pin the s=0 cross-section ring
        st = Settings(verbose=0, admm_iters=5, linsolver=3,
                      dtype=np.float64, pcg_max_iters=40, pcg_tol=1e-10)
        assert s.initialize(st)
        has = any(b.stencil is not None for b in s.system.tets)
        assert has == use_stencil
        for _ in range(3):
            s.step()
        return np.array(s.x)

    a = run(True, monkeypatch)
    b = run(False, monkeypatch)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def _grid_tris_imajor(nx, ny):
    """matrix.py _cloth_solver layout: vid = i*(ny+1)+j, cells i-outer."""
    vid = lambda i, j: i * (ny + 1) + j
    tris = []
    for i in range(nx):
        for j in range(ny):
            tris.append([vid(i, j), vid(i + 1, j), vid(i, j + 1)])
            tris.append([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    return np.asarray(tris), (nx + 1) * (ny + 1)


def test_verify_tri_grid_detects_and_rejects():
    from admm_elastic_tpu.geometry.factory import make_plane, make_sphere

    # i-major sheet (the cloth-bench layout).
    tris, nv = _grid_tris_imajor(5, 3)
    meta = stencil.verify_tri_grid(tris, n_local_verts=nv)
    assert meta is not None
    base, g0, g1, pats = meta
    assert (base, g0, g1) == (0, 6, 4)
    assert len(pats) == 2
    # make_plane layout (j-outer cells, vid = j*(nx+1)+i).
    plane = make_plane(4, 6)
    meta2 = stencil.verify_tri_grid(plane.faces,
                                    n_local_verts=len(plane.vertices))
    assert meta2 is not None
    # Permuted triangle order breaks the cell-major contract.
    rng = np.random.default_rng(0)
    assert stencil.verify_tri_grid(
        tris[rng.permutation(len(tris))], n_local_verts=nv) is None
    # An unstructured mesh is rejected.
    sph = make_sphere((0, 0, 0), 1.0, subdiv=8)
    assert stencil.verify_tri_grid(
        sph.faces, n_local_verts=len(sph.vertices)) is None


def _flat_grid_verts(nx, ny):
    return np.array(
        [[i * 0.31, 0.0, j * 0.27] for i in range(nx + 1)
         for j in range(ny + 1)], dtype=np.float64)


def _tri_batches(tris, verts, off=0):
    lame = Lame.from_youngs_poisson(1e7, 0.399)
    lame.limit_min, lame.limit_max = 0.95, 1.05
    flat = el.build_tri_batch(verts, tris, lame, vertex_offset=off)
    import os

    os.environ["ADMM_NO_STENCIL"] = "1"
    try:
        ref = el.build_tri_batch(verts, tris, lame, vertex_offset=off)
    finally:
        del os.environ["ADMM_NO_STENCIL"]
    assert flat.stencil is not None and ref.stencil is None
    plan = stencil.tri_flat_plan(tris, flat.stencil)
    return flat, ref, plan


def test_tri_flat_stencil_dx_dt_match_gather():
    import jax.numpy as jnp

    from admm_elastic_tpu.geometry.factory import make_plane

    plane = make_plane(4, 5)
    for tris, verts in (
        (_grid_tris_imajor(5, 4)[0], _flat_grid_verts(5, 4)),
        (np.asarray(plane.faces), np.asarray(plane.vertices)),
    ):
        nv = len(verts)
        flat, ref, plan = _tri_batches(tris, verts)
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((nv, 3)))
        live = plan.src >= 0

        rows_flat = np.asarray(stencil.tri_Dx_rows(x, flat))
        rows_ref = np.asarray(red.tri_Dx_rows(x, ref.inds, ref.Dlocal))
        np.testing.assert_allclose(rows_flat[:, live],
                                   rows_ref[:, plan.src[live]],
                                   rtol=1e-12, atol=1e-12)
        # Dead lanes carry the identity 3x2 F (rows 0 and 3 = 1).
        ident = np.zeros((6, int((~live).sum())))
        ident[[0, 3]] = 1.0
        np.testing.assert_allclose(rows_flat[:, ~live], ident, atol=1e-15)

        g_ref = rng.standard_normal((6, ref.n))
        g_flat = np.zeros((6, flat.n))
        g_flat[:, live] = g_ref[:, plan.src[live]]
        gi = jnp.asarray(red.build_gather_table(tris, nv))
        np.testing.assert_allclose(
            np.asarray(stencil.tri_Dt_rows(jnp.asarray(g_flat), flat, nv)),
            np.asarray(red.tri_Dt_rows(jnp.asarray(g_ref), ref.inds,
                                       ref.Dlocal, nv, gi)),
            rtol=1e-12, atol=1e-12)


def test_tri_flat_stencil_offset_family():
    import jax.numpy as jnp

    tris, nv = _grid_tris_imajor(3, 4)
    verts = _flat_grid_verts(3, 4)
    off = 23
    flat, ref, plan = _tri_batches(tris, verts, off=off)
    n_total = off + nv + 7
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((n_total, 3)))
    live = plan.src >= 0
    np.testing.assert_allclose(
        np.asarray(stencil.tri_Dx_rows(x, flat))[:, live],
        np.asarray(red.tri_Dx_rows(x, ref.inds, ref.Dlocal))[:, plan.src[live]],
        rtol=1e-12, atol=1e-12)
    g_ref = rng.standard_normal((6, ref.n))
    g_flat = np.zeros((6, flat.n))
    g_flat[:, live] = g_ref[:, plan.src[live]]
    np.testing.assert_allclose(
        np.asarray(stencil.tri_Dt_rows(jnp.asarray(g_flat), flat, n_total)),
        np.asarray(red.tri_Dt_rows(jnp.asarray(g_ref), ref.inds, ref.Dlocal,
                                   n_total)),
        rtol=1e-12, atol=1e-12)


def test_tri_stencil_full_step_trajectory_matches(monkeypatch):
    """End-to-end cloth: auto-detected stencil vs forced gather path."""
    from admm_elastic_tpu import Lame, Settings, Solver
    from admm_elastic_tpu.geometry.mesh import lumped_masses_tri

    def run(use_stencil, monkeypatch):
        if not use_stencil:
            monkeypatch.setenv("ADMM_NO_STENCIL", "1")
        else:
            monkeypatch.delenv("ADMM_NO_STENCIL", raising=False)
        nx = ny = 6
        verts = np.array(
            [[i, 0.0, j] for i in range(nx + 1) for j in range(ny + 1)],
            dtype=np.float64)
        tris, _ = _grid_tris_imajor(nx, ny)
        s = Solver()
        s.add_nodes(verts, lumped_masses_tri(verts, tris, 1522.0))
        lame = Lame.from_youngs_poisson(1e7, 0.399)
        lame.limit_min, lame.limit_max = 0.95, 1.05
        s.add_tri_energies(verts, tris, lame)
        s.set_pins([int(i) for i in np.where(verts[:, 0] < 1e-9)[0]])
        st = Settings(verbose=0, admm_iters=5, linsolver=3,
                      dtype=np.float64, pcg_max_iters=40, pcg_tol=1e-10)
        assert s.initialize(st)
        has_stencil = any(b.stencil is not None for b in s.system.tris)
        assert has_stencil == use_stencil
        for _ in range(3):
            s.step()
        return np.array(s.x)

    a = run(True, monkeypatch)
    b = run(False, monkeypatch)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_stencil_full_step_trajectory_matches():
    """End-to-end: binding path (stencil auto-on) vs explicit gather path
    on the same beam — trajectories agree to solver roundoff."""
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.mesh import lumped_masses_tet

    def run(use_stencil):
        mesh = make_tet_blocks(6, 3, 3)
        mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
        s = Solver()
        if use_stencil:
            binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        else:
            masses = lumped_masses_tet(mesh.vertices, mesh.tets, 1522.0)
            s.add_nodes(mesh.vertices, masses)
            s.add_tet_energies(mesh.vertices, mesh.tets, Lame.soft_rubber(),
                               model="neohookean", lattice_dims=None)
        pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
        s.set_pins(pins)
        st = Settings(verbose=0, admm_iters=5, linsolver=3,
                      dtype=np.float64, pcg_max_iters=40, pcg_tol=1e-10)
        assert s.initialize(st)
        has_stencil = any(b.stencil is not None for b in s.system.tets)
        assert has_stencil == use_stencil
        for _ in range(3):
            s.step()
        return np.array(s.x)

    a = run(True)
    b = run(False)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
