"""admm_elastic_tpu — a TPU-native ADMM elastodynamics framework.

A from-scratch JAX/XLA/Pallas implementation of implicit time integration of
elastic bodies as an ADMM optimization, with the same capabilities as the
reference C++/OpenMP library ``mattoverby/admm-elastic`` (ADMM ⊇ Projective
Dynamics, Overby et al., IEEE TVCG 2017):

- per-element proximal local steps (linear / NeoHookean / StVK / Xu-spline
  tets, strain-limited triangles, hard pins) run as batched XLA/Pallas
  kernels over struct-of-array element families,
- the constant global system ``A = M + dt^2 D^T W^2 D`` is solved with a
  GPU-friendly method (one-time equilibrated-inverse prefactor with
  batched RHS, multicolor SOR Gauss-Seidel, Uzawa Schur-complement CG
  with dense or sparse ELL-PCG inner, matrix-free PCG with Jacobi or
  two-grid preconditioning, or augmented-Lagrangian PCG hard contact),
  exploiting the fact that A is component-decoupled (N x N, 3 RHS),
- dynamic hard constraints (contact, pins, self-collision) enter through
  masked fixed-capacity hit buffers so the whole timestep stays jit-stable,
- scaling is scenario-batching + mesh sharding over a ``jax.sharding.Mesh``
  (see :mod:`admm_elastic_tpu.parallel`), not threads.

Reference parity notes cite the original implementation as ``file:line``
of https://github.com/mattoverby/admm-elastic.
"""

from admm_elastic_tpu.config import Settings
from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.solver import Solver
from admm_elastic_tpu.collision.passive import Floor, Sphere, PassiveMeshSDF, PassiveMeshExact

__version__ = "0.2.0"

__all__ = [
    "Settings",
    "Lame",
    "Solver",
    "Floor",
    "Sphere",
    "PassiveMeshSDF",
    "PassiveMeshExact",
]
