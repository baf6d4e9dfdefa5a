"""Fused hyperelastic tet local step: one Pallas kernel through Triton.

The ADMM local step of a hyperelastic tet family (the reference's OpenMP
element loop, src/Solver.cpp:84-87, with the dual update of
src/EnergyTerm.hpp:130-140) is, per element: v = D x + u, signed 3x3 SVD,
projected Newton in principal-stretch space, recompose z, u' = v - z. As
plain jnp it is a long Python-unrolled elementwise chain (8 Jacobi
sweeps, 8 Newton iterations with 8 backtracking evaluations each) that
XLA may split into several fusions, each writing its intermediates to
device memory. This kernel runs the whole chain for a block of elements
in registers: 9 rows of D x and 9 rows of u in, 18 rows out.

Layout: struct-of-arrays rows [9, T], the same layout the jnp path uses.
Only the element axis is blocked: each program owns BLOCK consecutive
elements (a power of two, one element per thread) and loads each row as
a 1-D vector with a tail mask. Masked-off lanes read an identity F and
unit material parameters, so dead lanes stay finite (J = 1, log J = 0).
The numerical body is shared verbatim with the jnp path
(ops/hyper_soa.prox_tet_hyper_tuple), so the two agree to reassociation.

Rounding: Triton lowers an f32 `/` to div.full.f32 (2 ulp) and sqrt to
sqrt.approx.f32, where XLA and the CPU round both to nearest. The body
is therefore traced to a jaxpr and evaluated with every f32 div and
sqrt replaced by the round-to-nearest PTX instruction (_round_to_nearest).

Sharding: the kernel is a custom call that the SPMD partitioner cannot
split, so it would gather its operands and run whole on every device.
Under a mesh with a "shard" axis (parallel/batch.py) the call is wrapped
in shard_map over the element axis, and each device runs its own slice.

set_pallas_mode("interpret") runs the kernel in the Pallas interpreter
(CPU tests); "auto" compiles it for the GPU. Which path the local step
takes is decided by system.elements.local_step_path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton
from jax.extend import core as jex_core
from jax.sharding import PartitionSpec as P

from admm_elastic_tpu.ops import hyper_soa

_MODE = "auto"

# Elements per program and warps per program (one element per thread).
BLOCK = 128
NUM_WARPS = 4

# Mesh axis over which the element axis is split (parallel/batch.py).
SHARD_AXIS = "shard"

_IDENTITY9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

# Round-to-nearest PTX for the f32 primitives Triton would approximate.
_RN_PTX = {
    jax.lax.div_p: ("div.rn.f32 $0, $1, $2;", "=r,r,r"),
    jax.lax.sqrt_p: ("sqrt.rn.f32 $0, $1;", "=r,r"),
}


def set_pallas_mode(mode: str) -> None:
    """'auto' (compile for the GPU) or 'interpret' (Pallas interpreter)."""
    global _MODE
    if mode not in ("auto", "interpret"):
        raise ValueError(f"bad pallas mode {mode!r}")
    _MODE = mode


def interpret_mode() -> bool:
    return _MODE == "interpret"


def _rn_ptx(prim, aval, *args):
    asm, constraints = _RN_PTX[prim]
    args = [jnp.broadcast_to(a, aval.shape).astype(aval.dtype) for a in args]
    return pltriton.elementwise_inline_asm(
        asm, args=args, constraints=constraints, pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(aval.shape, aval.dtype)])[0]


def _replace_eval(jaxpr, consts, replace, *args):
    """Evaluate `jaxpr`, binding `replace[prim](prim, aval, *args)` in
    place of each f32 equation whose primitive is a key of `replace`.
    Inner jit calls are inlined; the jaxprs of loops are rewritten the
    same way and the loop is kept."""
    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, jex_core.Literal) else env[v]

    for eqn in jaxpr.eqns:
        invals = [read(v) for v in eqn.invars]
        aval = eqn.outvars[0].aval
        if eqn.primitive in replace and aval.dtype == jnp.float32:
            outs = [replace[eqn.primitive](eqn.primitive, aval, *invals)]
        elif eqn.primitive.name == "jit":
            inner = eqn.params["jaxpr"]
            outs = _replace_eval(inner.jaxpr, inner.consts, replace, *invals)
        else:
            params = {k: (_replace_closed(v, replace)
                          if isinstance(v, jex_core.ClosedJaxpr) else v)
                      for k, v in eqn.params.items()}
            subfuns, params = eqn.primitive.get_bind_params(params)
            outs = eqn.primitive.bind(*subfuns, *invals, **params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def _replace_closed(closed, replace):
    avals = [jax.ShapeDtypeStruct(v.aval.shape, v.aval.dtype,
                                  weak_type=v.aval.weak_type)
             for v in closed.jaxpr.invars]
    return jax.make_jaxpr(functools.partial(
        _replace_eval, closed.jaxpr, closed.consts, replace))(*avals)


def replace_primitives(fn, replace):
    """fn with each f32 equation of a primitive in `replace` evaluated by
    `replace[prim](prim, aval, *args)`, through loops and inner jits."""
    def wrapped(*args):
        closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*args)
        outs = _replace_eval(closed.jaxpr, closed.consts, replace,
                             *jax.tree.leaves(args))
        return jax.tree.unflatten(jax.tree.structure(out_shape), outs)
    return wrapped


def _round_to_nearest(fn):
    return replace_primitives(fn, {p: _rn_ptx for p in _RN_PTX})


def _local_hyper_kernel(model, n_iters, sweeps, t, block, interpret,
                        dix_ref, u_ref, mu_ref, lam_ref, kappa_ref, k_ref,
                        z_ref, uo_ref):
    i = pl.program_id(0)
    live = i * block + jnp.arange(block) < t
    sl = pl.ds(i * block, block)

    def row(ref, r, other):
        # int32 row index: the slice start is int32 even when x64 is on.
        return pltriton.load(ref.at[jnp.int32(r), sl], mask=live,
                             other=other)

    def param(ref, other):
        return pltriton.load(ref.at[sl], mask=live, other=other)

    v = tuple(row(dix_ref, r, _IDENTITY9[r]) + row(u_ref, r, 0.0)
              for r in range(9))
    def prox(v, mu, lam, kappa, k):
        return hyper_soa.prox_tet_hyper_tuple(
            v, model, mu, lam, kappa, k, n_iters=n_iters, sweeps=sweeps,
            unroll=False)

    if not interpret:
        prox = _round_to_nearest(prox)
    z = prox(v, param(mu_ref, 1.0), param(lam_ref, 1.0),
             param(kappa_ref, 0.0), param(k_ref, 1.0))
    for r in range(9):
        pltriton.store(z_ref.at[jnp.int32(r), sl], z[r], mask=live)
        pltriton.store(uo_ref.at[jnp.int32(r), sl], v[r] - z[r], mask=live)


@functools.partial(
    jax.jit, static_argnames=("model", "n_iters", "sweeps", "block",
                              "num_warps", "interpret"))
def _local_hyper_call(dix, u, mu, lam, kappa, k, model, n_iters, sweeps,
                      block, num_warps, interpret):
    t = dix.shape[1]
    rows = jax.ShapeDtypeStruct((9, t), dix.dtype)
    return pl.pallas_call(
        functools.partial(_local_hyper_kernel, model, n_iters, sweeps, t,
                          block, interpret),
        grid=(pl.cdiv(t, block),),
        out_shape=(rows, rows),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="local_step_tet_hyper",
    )(dix, u, mu, lam, kappa, k)


def local_step_tet_hyper_pallas(dix_rows, u_rows, model: str, mu, lam, kappa,
                                k, n_iters: int = 8, sweeps: int = 8):
    """Fused tet local step on rows [9, T]: returns (z_rows, u_new_rows)."""
    t = dix_rows.shape[1]
    args = (dix_rows, u_rows, mu, lam, kappa, jnp.broadcast_to(k, (t,)))
    call = functools.partial(
        _local_hyper_call, model=model, n_iters=n_iters, sweeps=sweeps,
        block=BLOCK, num_warps=NUM_WARPS, interpret=interpret_mode())
    mesh = jax.sharding.get_abstract_mesh()
    n_shard = 1 if mesh.empty else dict(mesh.shape).get(SHARD_AXIS, 1)
    if n_shard == 1:
        return call(*args)
    # Pad the element axis to a multiple of the shard count with inert
    # elements (identity F, unit parameters), as the masked tail does.
    pad = -t % n_shard
    fill = (jnp.asarray(_IDENTITY9, dix_rows.dtype)[:, None], 0.0, 1.0, 1.0,
            0.0, 1.0)
    args = [jnp.concatenate([a, jnp.broadcast_to(
        jnp.asarray(f, a.dtype), a.shape[:-1] + (pad,))], axis=-1)
        for a, f in zip(args, fill)]
    rows, elems = P(None, SHARD_AXIS), P(SHARD_AXIS)
    z, u_new = jax.shard_map(
        call, mesh=mesh, in_specs=(rows, rows) + (elems,) * 4,
        out_specs=(rows, rows), axis_names={SHARD_AXIS},
        check_vma=False)(*args)
    return z[:, :t], u_new[:, :t]
