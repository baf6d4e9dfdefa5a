"""State checkpoint/resume.

The reference has none (SURVEY §5): its full state is (m_x, m_v). Long
batched device sweeps warrant real checkpointing; the SimState pytree is the
entire checkpoint surface.
"""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu.system.system import SimState


def save_state(path: str, state: SimState, **extra):
    np.savez(
        path,
        x=np.asarray(state.x),
        v=np.asarray(state.v),
        y=np.asarray(state.y),
        prev_active=np.asarray(state.prev_active),
        **extra,
    )


def load_state(path: str, dtype=None) -> SimState:
    import jax.numpy as jnp

    with np.load(path) as data:
        cast = (lambda a: jnp.asarray(a, dtype=dtype)) if dtype else jnp.asarray
        return SimState(
            x=cast(data["x"]),
            v=cast(data["v"]),
            y=cast(data["y"]),
            # Round-1 checkpoints stored an i32 count ("n_active_prev");
            # migrate to the mask form conservatively (all-False resets
            # the Uzawa warm start on the first post-load solve, which is
            # always safe).
            prev_active=(jnp.asarray(data["prev_active"], bool)
                         if "prev_active" in data
                         else jnp.zeros(data["y"].shape, dtype=bool)),
        )
