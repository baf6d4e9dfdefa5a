"""Scene binding: add whole meshes (nodes + masses + energies + colliders)
to a Solver in one call.

Mirrors the reference binding layer (samples/utils/AddMeshes.hpp):
- add_tetmesh: rubber-density lumped masses (1522 kg/m^3), zero-mass
  validation, node append, TetMeshCollision + surface indices unless
  NOSELFCOLLISION, energy family dispatch by flag (AddMeshes.hpp:97-177).
- add_trimesh: cloth analogue (AddMeshes.hpp:208-210).
- GrabbySphere: radius vertex picker for interactive pinning
  (AddMeshes.hpp:70-91).
"""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu.collision.dynamic import make_tet_mesh_collider
from admm_elastic_tpu.geometry.mesh import TetMesh, TriangleMesh
from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.solver import Solver

# Mesh flags bitmask (AddMeshes.hpp:57-62).
NOSELFCOLLISION = 1 << 1
LINEAR = 1 << 2
NEOHOOKEAN = 1 << 3
STVK = 1 << 4
SPLINE = 1 << 5  # extension: Xu-spline material family

_FLAG_TO_MODEL = {
    LINEAR: "linear",
    NEOHOOKEAN: "neohookean",
    STVK: "stvk",
    SPLINE: "spline_nh",
}

RUBBER_DENSITY = 1522.0  # kg/m^3 (AddMeshes.hpp:105)


def add_tetmesh(solver: Solver, mesh: TetMesh, lame: Lame | None = None, verbose: bool = True,
                density: float = RUBBER_DENSITY):
    """Append a tet mesh to the solver (AddMeshes.hpp:97-177)."""
    if lame is None:
        lame = Lame.rubber()
    prev_verts = solver._n_verts
    masses = mesh.weighted_masses(density)
    if np.any(masses <= 0.0):
        raise RuntimeError("TetMesh Error: Zero mass")
    solver.add_nodes(mesh.vertices, masses)

    if not (mesh.flags & NOSELFCOLLISION):
        collider = make_tet_mesh_collider(
            mesh.vertices, mesh.tets, mesh.faces, prev_verts
        )
        solver.add_dynamic_collider(collider)
        for i in mesh.surface_inds():
            solver.surface_inds.append(int(i) + prev_verts)

    model = "linear"
    for flag, m in _FLAG_TO_MODEL.items():
        if mesh.flags & flag:
            model = m
    solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model,
                            vertex_offset=prev_verts,
                            lattice_dims=getattr(mesh, "lattice_dims", None),
                            lattice_wrap=getattr(mesh, "lattice_wrap", False))

    if verbose:
        print(
            f"Added mesh:\n\tmass: {masses.sum()}kg\n\tvertices: {len(mesh.vertices)}"
            f"\n\ttets: {len(mesh.tets)}\n\t(total) verts: {solver._n_verts}"
        )
    return prev_verts


def add_trimesh(solver: Solver, mesh: TriangleMesh, lame: Lame | None = None,
                verbose: bool = True, density: float = 1.0):
    """Append a triangle (cloth) mesh (AddMeshes.hpp:186-235)."""
    if lame is None:
        lame = Lame.rubber()
    prev_verts = solver._n_verts
    masses = mesh.weighted_masses(density)
    if np.any(masses <= 0.0):
        raise RuntimeError("TriMesh Error: Zero mass")
    solver.add_nodes(mesh.vertices, masses)
    solver.add_tri_energies(mesh.vertices, mesh.faces, lame, vertex_offset=prev_verts)
    if verbose:
        print(
            f"Added mesh:\n\tmass: {masses.sum()}kg\n\tvertices: {len(mesh.vertices)}"
            f"\n\ttris: {len(mesh.faces)}\n\t(total) verts: {solver._n_verts}"
        )
    return prev_verts


class GrabbySphere:
    """Radius vertex picker for interactive pinning (AddMeshes.hpp:70-91)."""

    def __init__(self, center, radius: float):
        self.c = np.asarray(center, dtype=np.float64)
        self.r = float(radius)

    def get_indices(self, x: np.ndarray) -> list[int]:
        x = np.asarray(x).reshape(-1, 3)
        d = np.linalg.norm(x - self.c, axis=-1)
        return [int(i) for i in np.where(d < self.r)[0]]
