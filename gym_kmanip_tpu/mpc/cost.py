"""Cost library for trajectory optimization / sampling MPC.

The cube-pick running cost is the negated shaped reward of the reference
task (get_reward, /root/reference/gym_kmanip/env_sim.py:148-179): velocity
penalty, inverse-distance gripper shaping, touch/lift bonuses -- plus
smooth optional terms (EE goal tracking, control effort) that the
optimizers need but the reference env never exposed.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics.state import SimState, StepAux
from gym_kmanip_tpu.models.spec import RobotModel


class CostParams(NamedTuple):
    """Weights for the cube-pick running cost.

    Defaults are HOST values (floats / numpy), never jnp arrays: a jitted
    cost closure that captures a pre-existing DEVICE array turns it into a
    hidden program input (tests/test_no_device_closures.py); host
    constants are baked into the HLO as literals.
    Callers may still pass jax arrays explicitly (e.g. as traced operands).
    """

    w_vel: jax.typing.ArrayLike = k.REWARD_VEL_PENALTY
    w_grip_dist: jax.typing.ArrayLike = k.REWARD_GRIP_DIST
    w_touch: jax.typing.ArrayLike = k.REWARD_TOUCH_CUBE
    w_lift: jax.typing.ArrayLike = k.REWARD_LIFT_CUBE
    w_ctrl: jax.typing.ArrayLike = 1e-3  # smooth control-effort term
    # optional EE goal (for tracking-style tasks); NaN disables
    ee_goal: jax.typing.ArrayLike = np.full((3,), np.nan, dtype=np.float32)
    w_ee_goal: jax.typing.ArrayLike = 10.0


def _safe_norm(x: jax.Array) -> jax.Array:
    """Norm with a finite derivative at 0 (double-where; plain norm NaNs
    under jacfwd at rest states, which are iLQR linearization points)."""
    sq = jnp.sum(x * x)
    return jnp.sqrt(jnp.where(sq < 1e-16, 1e-16, sq))


def cube_pick_cost(
    model: RobotModel,
    state: SimState,
    aux: StepAux,
    ctrl: jax.Array,
    params: CostParams,
    use_right: bool = True,
    use_left: bool = False,
) -> jax.Array:
    """Per-step cost = -reward(reference shape) + control regularization."""
    qvel_full = jnp.concatenate([state.qvel, state.cube_linvel, state.cube_angvel])
    c = params.w_vel * _safe_norm(qvel_full)
    if use_right:
        i = model.site_index("eer_site")
        dist = jnp.linalg.norm(state.cube_pos - aux.site_pos[i])
        c = c - params.w_grip_dist / (dist + k.EPSILON)
    if use_left:
        i = model.site_index("eel_site")
        dist = jnp.linalg.norm(state.cube_pos - aux.site_pos[i])
        c = c - params.w_grip_dist / (dist + k.EPSILON)
    touched = aux.touch_r | aux.touch_l
    c = c - jnp.where(touched, params.w_touch, 0.0)
    c = c - jnp.where(touched & ~aux.touch_table, params.w_lift, 0.0)
    c = c + params.w_ctrl * jnp.sum((ctrl - state.qpos[: model.nu]) ** 2)

    ee_active = ~jnp.isnan(params.ee_goal[0])
    i = model.site_index("eer_site")
    ee_err = jnp.sum((aux.site_pos[i] - jnp.nan_to_num(params.ee_goal)) ** 2)
    c = c + jnp.where(ee_active, params.w_ee_goal * ee_err, 0.0)
    return c


def make_ee_tracking_cost_ilqr(
    model: RobotModel,
    goal_pos,
    site: str = "eer_site",
    w_pos: float = 50.0,
    w_vel: float = 0.01,
    w_ctrl: float = 1e-3,
):
    """(cost_xu, quad_xu) pair for iLQR EE tracking on the flat state
    x = [qpos, qvel, (cube...)] (solvers/ilqr layout; cube dims, if
    present, carry zero cost rows).

    quad_xu is the GAUSS-NEWTON quadratization: cxx's FK block is
    w·J'J from ONE reverse-mode Jacobian of the 3-vector site residual,
    instead of jax.hessian differentiating the whole kinematic chain
    twice per timestep — measured 20.4 -> 14.3 ms on the torso H=100
    fused solve, with an equal-or-better convergence trace (GN is the
    standard iLQR cost model; pass quad_xu=None to ilqr for the exact
    autodiff Hessian)."""
    from gym_kmanip_tpu.ops import kinematics as kin

    nq, nu = model.nq, model.nu
    goal = jnp.asarray(goal_pos)

    def ee_of_q(q):
        xp, xq, _ = kin.fk(model, q)
        p, _ = kin.site_pose(model, xp, xq, site)
        return p

    def cost_xu(x, u):
        q, v = x[:nq], x[nq : 2 * nq]
        return (
            w_pos * jnp.sum((ee_of_q(q) - goal) ** 2)
            + w_vel * jnp.sum(v**2)
            + w_ctrl * jnp.sum(u**2)
        )

    def quad_xu(x, u):
        n = x.shape[-1]
        q, v = x[:nq], x[nq : 2 * nq]
        r = ee_of_q(q) - goal
        J = jax.jacrev(ee_of_q)(q)  # (3, nq)
        cx = jnp.zeros((n,), x.dtype)
        cx = cx.at[:nq].set(2.0 * w_pos * (J.T @ r))
        cx = cx.at[nq : 2 * nq].set(2.0 * w_vel * v)
        cu = 2.0 * w_ctrl * u
        cxx = jnp.zeros((n, n), x.dtype)
        cxx = cxx.at[:nq, :nq].set(2.0 * w_pos * (J.T @ J))
        cxx = cxx.at[nq : 2 * nq, nq : 2 * nq].set(
            2.0 * w_vel * jnp.eye(nq, dtype=x.dtype)
        )
        cuu = 2.0 * w_ctrl * jnp.eye(nu, dtype=x.dtype)
        cux = jnp.zeros((nu, n), x.dtype)
        return cx, cu, cxx, cuu, cux

    return cost_xu, quad_xu


def ee_tracking_cost(
    model: RobotModel,
    state: SimState,
    aux: StepAux,
    ctrl: jax.Array,
    goal_pos: jax.Array,
    w_pos: float = 100.0,
    w_vel: float = 0.01,
    w_ctrl: float = 1e-3,
) -> jax.Array:
    """Pure EE goal-reaching cost (for BASELINE's EE tracking metric)."""
    i = model.site_index("eer_site")
    c = w_pos * jnp.sum((aux.site_pos[i] - goal_pos) ** 2)
    c = c + w_vel * jnp.sum(state.qvel**2)
    c = c + w_ctrl * jnp.sum((ctrl - state.qpos[: model.nu]) ** 2)
    return c
