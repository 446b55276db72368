"""Batched horizon rollouts: the compute core of sampling MPC.

Replaces nothing in the reference (it has no MPC; SURVEY.md §2.4) -- this is
the extension the BASELINE north star requires: thousands of horizon-H
rollouts of the full articulated dynamics as ONE compiled program, `vmap`
over the rollout batch (which `shard_map` then splits over devices),
`lax.scan` over the horizon.

For speed, MPC rollouts integrate at the control rate by default
(n_substeps=1 at dt=0.02) rather than the env's 10x2 ms; the env remains
the high-fidelity evaluator. This is the standard model-predictive
"coarse model / fine plant" split and is configurable.
"""

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import contacts
from gym_kmanip_tpu.dynamics.engine import substep, _tip_state
from gym_kmanip_tpu.dynamics.state import SimState, StepAux
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.ops import kinematics as kin
from gym_kmanip_tpu.utils.precision import highest_precision


@highest_precision
def mpc_step(
    model: RobotModel,
    state: SimState,
    ctrl: jax.Array,
    n_substeps: int,
    dt: float,
    contact: bool = True,
    unrolled_solve: bool = True,
    implicit_actuation: bool = True,
) -> Tuple[SimState, StepAux]:
    """Control step variant for rollouts.

    Unlike the env path (engine.control_step), site poses and touch flags
    come from the LAST substep's already-computed forward pass -- a
    one-substep time shift that saves a full extra FK per rollout step
    (~2x on the n_substeps=1 MPC fast path). Cost functions see the same
    shift for every candidate, so MPPI/iLQR rankings are unaffected.
    """
    state = state._replace(ctrl=ctrl)

    def body(s, _):
        s2, (touch, xp, xq) = substep(
            model, s, dt, contact=contact, unrolled_solve=unrolled_solve,
            implicit_actuation=implicit_actuation,
        )
        return s2, (touch, xp, xq)

    state, (touches, xps, xqs) = jax.lax.scan(body, state, None, length=n_substeps)

    xpos, xquat = xps[-1], xqs[-1]
    site_pos, site_quat = kin.all_site_poses(model, xpos, xquat)
    touch_last = touches[-1]
    sides_r = jnp.asarray([t.side == "r" for t in model.fingertips], dtype=bool)
    sides_l = jnp.asarray([t.side == "l" for t in model.fingertips], dtype=bool)
    if contact:
        _, _, touch_table = contacts.cube_table(
            state.cube_pos, state.cube_quat, state.cube_linvel, state.cube_angvel
        )
    else:
        touch_table = jnp.asarray(False)
    from gym_kmanip_tpu.dynamics.engine import _tips_from_frames

    aux = StepAux(
        touch_r=jnp.any(touch_last & sides_r),
        touch_l=jnp.any(touch_last & sides_l),
        touch_table=touch_table,
        site_pos=site_pos,
        site_quat=site_quat,
        qfrc_contact=jnp.zeros_like(state.qvel),
        tip_pos=_tips_from_frames(model, xpos, xquat),
    )
    return state, aux


@highest_precision
def rollout(
    model: RobotModel,
    state0: SimState,
    ctrl_seq: jax.Array,  # (H, nu)
    cost_fn: Callable,  # (state, aux, ctrl) -> scalar
    n_substeps: int = 1,
    dt: float = k.CONTROL_TIMESTEP,
    contact: bool = True,
    implicit_actuation: bool = True,
) -> Tuple[jax.Array, SimState]:
    """Roll a control sequence; returns (total_cost, final_state)."""

    def body(s, ctrl):
        s2, aux = mpc_step(
            model, s, ctrl, n_substeps, dt, contact=contact,
            implicit_actuation=implicit_actuation,
        )
        c = cost_fn(s2, aux, ctrl)
        return s2, c

    state_f, costs = jax.lax.scan(body, state0, ctrl_seq)
    return jnp.sum(costs), state_f


@highest_precision
def rollout_with_traj(
    model: RobotModel,
    state0: SimState,
    ctrl_seq: jax.Array,
    cost_fn: Callable,
    n_substeps: int = 1,
    dt: float = k.CONTROL_TIMESTEP,
) -> Tuple[jax.Array, SimState, jax.Array]:
    """Like `rollout` but also returns the per-step cost trace (H,)."""

    def body(s, ctrl):
        s2, aux = mpc_step(model, s, ctrl, n_substeps, dt)
        c = cost_fn(s2, aux, ctrl)
        return s2, (c, s2.qpos)

    state_f, (costs, qs) = jax.lax.scan(body, state0, ctrl_seq)
    return jnp.sum(costs), state_f, costs
