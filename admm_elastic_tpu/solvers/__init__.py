"""Global-step linear solvers.

Reference mapping (src/Solver.cpp:229-241, `-ls` flag):
  0 LDLT prefactor      -> :mod:`direct` (one-time Cholesky of the N x N
                           single-component matrix, batched 3-RHS solves)
  1 NodalMultiColorGS   -> :mod:`gs` (color-batched SOR with pin override
                           and per-node contact-plane projection)
  2 UzawaCG             -> :mod:`uzawa` (Schur-complement CG on top of the
                           prefactored apply)
  3 (extension)         -> :mod:`pcg` (matrix-free Jacobi-PCG, shardable)
"""
