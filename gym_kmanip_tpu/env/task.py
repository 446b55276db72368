"""Jitted task core: action decode -> IK -> physics -> obs -> reward.

JAX equivalent of KManipTask (dm_control base.Task at
/root/reference/gym_kmanip/env_sim.py:18-179). The entire control step --
gripper/EE/qpos action decoding (before_step, env_sim.py:38-108), the IK
solves, 10 physics substeps, observation extraction (get_observation,
env_sim.py:110-146) and reward (get_reward, env_sim.py:148-179) -- is ONE
compiled XLA program per env configuration, instead of a Python round-trip
into native MuJoCo per stage.

Everything here is pure: `make_task(cfg)` returns jitted (reset_fn, step_fn)
closures over the static model + config. The Gym shell in env_base.py owns
RNG, logging and numpy casting.
"""

from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics.engine import control_step
from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.ops import kinematics as kin
from gym_kmanip_tpu.solvers.ik import ik_trf
from gym_kmanip_tpu.solvers.ik_host import ik_trf_host, solve_host
from gym_kmanip_tpu.utils import rotations as rot

# Fix-and-document (SURVEY.md §2.2): the reference's touch/lift reward scans
# for geoms named left/right_gripper_finger which do not exist in its shipped
# XMLs, so those terms never fire there. Our fingertip geoms exist, so the
# code's contract works as written. Set False for strict reference-observable
# parity (reward = vel penalty + distance shaping only).
CONTACT_REWARD_ENABLED: bool = True


class TaskOut(NamedTuple):
    state: SimState
    obs: Dict[str, jax.Array]
    reward: jax.Array
    mocap_pos: jax.Array  # (n_mocap, 3) decoded EE goals (parity with mocap)
    mocap_quat: jax.Array  # (n_mocap, 4)


def _site_euler(model, qpos, site_name):
    xpos, xquat, _ = kin.fk(model, qpos)
    p, q = kin.site_pose(model, xpos, xquat, site_name)
    return p, q, rot.quat_to_euler_xyz(q)


def _ee_goal(model, cfg, state, action, side: str):
    """Decoded EE goal (pos, wxyz quat) for one arm — the IK inputs.

    Shared by the fused on-device decode and the split host-IK pipeline so
    both compute bit-identical goals from (state, action)."""
    site = f"ee{side}_site"
    qpos = state.qpos
    p, q, eul = _site_euler(model, qpos, site)
    goal_pos = (
        action[f"ee{side}_pos"] * jnp.asarray(k.EE_POS_DELTA, dtype=qpos.dtype) + p
    )
    goal_orn = rot.euler_xyz_to_quat(
        action[f"ee{side}_orn"] * jnp.asarray(k.EE_ORN_DELTA, dtype=qpos.dtype) + eul
    )
    return goal_pos, goal_orn


def _decode_action(
    model: RobotModel, cfg, state: SimState, action: Dict[str, jax.Array],
    ik_solutions: Dict[str, Tuple[jax.Array, jax.Array]] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """before_step (env_sim.py:38-108): action dict -> ctrl vector + mocap
    + the post-IK qpos.

    `ik_solutions`: optional {"r"/"l": (q_sol, q_scribble)} computed OUTSIDE
    this (traceable) function — the split host-IK pipeline (make_task with
    cfg.ik_host64) injects its f64 host solves here; when absent the f32
    on-device TRF solver runs inline.

    The returned qpos is behavior-defining reference parity: ik_res/ik_jac
    scribble every candidate q into the live physics.data.qpos and never
    restore it (ik_mujoco.py:33-34), so the reference's physics integrates
    from the last IK evaluation — the masked arm joints are effectively
    TELEPORTED to the IK solution each control step and the kp=1000 servos
    only mop up the residual. Callers must integrate from this qpos (with
    the pre-step qvel, which the reference leaves untouched).
    """
    qpos = state.qpos
    qpos_out = qpos
    ctrl = state.ctrl
    mocap_pos = jnp.asarray(model.mocap_pos0, dtype=qpos.dtype)
    mocap_quat = jnp.asarray(model.mocap_quat0, dtype=qpos.dtype)

    if "grip_r" in cfg.act_list:
        gid = tuple(int(i) for i in cfg.ctrl_id_r_grip)
        # quirk parity: the reference indexes qpos with the *ctrl* id
        # (env_sim.py:45) -- identical here because actuator i drives joint i
        grip = action["grip_r"][0] * k.EE_S_DELTA + qpos[gid[0]]
        grip = jnp.clip(grip, k.EE_S_MIN, k.EE_S_MAX)
        ctrl = ctrl.at[gid[0]].set(grip).at[gid[1]].set(grip)
    if "grip_l" in cfg.act_list:
        gid = tuple(int(i) for i in cfg.ctrl_id_l_grip)
        grip = action["grip_l"][0] * k.EE_S_DELTA + qpos[gid[0]]
        grip = jnp.clip(grip, k.EE_S_MIN, k.EE_S_MAX)
        ctrl = ctrl.at[gid[0]].set(grip).at[gid[1]].set(grip)

    q_home = jnp.asarray(cfg.q_pos_home, dtype=qpos.dtype)

    for side, mocap_id, mask_ids in (
        ("r", k.MOCAP_ID_R, cfg.q_id_r_mask),
        ("l", k.MOCAP_ID_L, cfg.q_id_l_mask),
    ):
        if f"ee{side}_pos" not in cfg.act_list:
            continue
        goal_pos, goal_orn = _ee_goal(model, cfg, state, action, side)
        mocap_pos = mocap_pos.at[mocap_id].set(goal_pos)
        mocap_quat = mocap_quat.at[mocap_id].set(goal_orn)
        mask = tuple(int(i) for i in mask_ids)
        if ik_solutions is not None:
            q_sol, q_scrib = ik_solutions[side]
        else:
            # scipy-TRF-parity solver: exact f64 host solve (ik_host64,
            # via pure_callback — for direct/traceable callers on
            # callback-supporting backends; the env pipeline built by
            # make_task injects ik_solutions instead)
            # or the f32 on-device TRF, which matches the reference's
            # least_squares trajectory to <1e-3 rad over 20 steps
            solver = ik_trf_host if cfg.ik_host64 else ik_trf
            q_sol, q_scrib = solver(
                model, qpos, goal_pos, goal_orn, q_home, qpos,
                q_mask=mask, site_name=f"ee{side}_site",
            )
        ctrl = ctrl.at[jnp.asarray(mask)].set(q_sol)
        qpos_out = qpos_out.at[jnp.asarray(mask)].set(q_scrib)

    if "q_pos_r" in cfg.act_list:
        mask = jnp.asarray(tuple(int(i) for i in cfg.q_id_r_mask))
        ctrl = ctrl.at[mask].set(qpos[mask] + action["q_pos_r"] * k.Q_POS_DELTA)
    if "q_pos_l" in cfg.act_list:
        mask = jnp.asarray(tuple(int(i) for i in cfg.q_id_l_mask))
        ctrl = ctrl.at[mask].set(qpos[mask] + action["q_pos_l"] * k.Q_POS_DELTA)

    # exponential ctrl filter (env_sim.py:106; CTRL_ALPHA=1 -> passthrough)
    ctrl = k.CTRL_ALPHA * ctrl + (1 - k.CTRL_ALPHA) * state.ctrl
    return ctrl, qpos_out, mocap_pos, mocap_quat


def _observe(model: RobotModel, cfg, state: SimState) -> Dict[str, jax.Array]:
    """get_observation (env_sim.py:110-146), state part only; cameras are
    rendered by the env shell via gym_kmanip_tpu.render."""
    obs = {}
    lo = jnp.asarray(model.jnt_range[:, 0], dtype=state.qpos.dtype)
    hi = jnp.asarray(model.jnt_range[:, 1], dtype=state.qpos.dtype)
    if "q_pos" in cfg.obs_list:
        q = (state.qpos - lo) / (hi - lo)
        obs["q_pos"] = jnp.clip(q, -1.0, 1.0)
    if "q_vel" in cfg.obs_list:
        obs["q_vel"] = jnp.clip(state.qvel / k.MAX_Q_VEL, -1.0, 1.0)
    if "cube_pos" in cfg.obs_list:
        rng = jnp.asarray(k.CUBE_SPAWN_RANGE, dtype=state.qpos.dtype)
        c = (state.cube_pos - rng[:, 0]) / (rng[:, 1] - rng[:, 0])
        obs["cube_pos"] = jnp.clip(c, -1.0, 1.0)
    if "cube_orn" in cfg.obs_list:
        obs["cube_orn"] = state.cube_quat
    return obs


def _reward(model: RobotModel, cfg, state: SimState, aux) -> jax.Array:
    """get_reward (env_sim.py:148-179)."""
    qvel_full = jnp.concatenate([state.qvel, state.cube_linvel, state.cube_angvel])
    r = -k.REWARD_VEL_PENALTY * jnp.linalg.norm(qvel_full)
    if "grip_l" in cfg.act_list:
        i = model.site_index("eel_site")
        dist = jnp.linalg.norm(state.cube_pos - aux.site_pos[i])
        r = r + k.REWARD_GRIP_DIST / (dist + k.EPSILON)
    if "grip_r" in cfg.act_list:
        i = model.site_index("eer_site")
        dist = jnp.linalg.norm(state.cube_pos - aux.site_pos[i])
        r = r + k.REWARD_GRIP_DIST / (dist + k.EPSILON)
    if CONTACT_REWARD_ENABLED:
        touched = aux.touch_r | aux.touch_l
        r = r + jnp.where(touched, k.REWARD_TOUCH_CUBE, 0.0)
        r = r + jnp.where(touched & ~aux.touch_table, k.REWARD_LIFT_CUBE, 0.0)
    return r


def make_task(cfg):
    """Build (reset_fn, step_fn) jitted closures for one env config.

    reset_fn(cube_pos) -> TaskOut at the home state with the cube spawned at
    `cube_pos` (the env shell samples it: np.random.uniform over
    CUBE_SPAWN_RANGE, matching initialize_episode env_sim.py:31-35).
    step_fn(state, action_dict) -> TaskOut.
    """
    model = get_model(cfg.mjcf_filename)

    def reset_fn(cube_pos: jax.Array) -> TaskOut:
        from gym_kmanip_tpu.dynamics.state import init_state

        state = init_state(model, cube_pos=cube_pos)
        xpos, xquat, _ = kin.fk(model, state.qpos)
        sp, sq = [], []
        for s in model.sites:
            p, qu = kin.site_pose(model, xpos, xquat, s.name)
            sp.append(p)
            sq.append(qu)
        from gym_kmanip_tpu.dynamics.state import StepAux

        from gym_kmanip_tpu.dynamics.engine import _tips_from_frames

        aux = StepAux(
            touch_r=jnp.asarray(False),
            touch_l=jnp.asarray(False),
            touch_table=jnp.asarray(True),
            site_pos=jnp.stack(sp),
            site_quat=jnp.stack(sq),
            qfrc_contact=jnp.zeros_like(state.qvel),
            tip_pos=_tips_from_frames(model, xpos, xquat),
        )
        obs = _observe(model, cfg, state)
        reward = _reward(model, cfg, state, aux)
        return TaskOut(
            state=state,
            obs=obs,
            reward=reward,
            mocap_pos=jnp.asarray(model.mocap_pos0, dtype=state.qpos.dtype),
            mocap_quat=jnp.asarray(model.mocap_quat0, dtype=state.qpos.dtype),
        )

    def step_core(
        state: SimState, action: Dict[str, jax.Array], ik_solutions=None
    ) -> TaskOut:
        ctrl, qpos_ik, mocap_pos, mocap_quat = _decode_action(
            model, cfg, state, action, ik_solutions
        )
        qpos_pre = state.qpos
        state = state._replace(qpos=qpos_ik)
        state, aux = control_step(model, state, ctrl, qpos_force=qpos_pre)
        obs = _observe(model, cfg, state)
        reward = _reward(model, cfg, state, aux)
        return TaskOut(state, obs, reward, mocap_pos, mocap_quat)

    ee_sides = [s for s in ("r", "l") if f"ee{s}_pos" in cfg.act_list]
    if not (cfg.ik_host64 and ee_sides):
        # one fused XLA program: decode (+ on-device f32 TRF IK if any EE
        # actions) -> physics -> obs -> reward
        return jax.jit(reset_fn), jax.jit(step_fn_fused(step_core)), model

    # --- split pipeline: goals (jit) -> f64 host IK (numpy) -> core (jit).
    # The exact-parity solver needs float64 (scipy's ftol/xtol sit below
    # f32 eps; solvers/ik_host.py docstring), so the host solve runs
    # BETWEEN two jitted programs instead of as a pure_callback inside one.
    # Same math, same order, every backend.
    def goals_fn(state: SimState, action: Dict[str, jax.Array]):
        return {
            side: _ee_goal(model, cfg, state, action, side)
            for side in ee_sides
        }

    goals_jit = jax.jit(goals_fn)
    core_jit = jax.jit(step_core)
    # f32 round-trip first: the pure_callback path hands the host solver the
    # f32 device value of q_home; match it bit-for-bit
    q_home_np = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
    masks = {
        side: tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask"))
        for side in ee_sides
    }

    def step_fn(state: SimState, action: Dict[str, jax.Array]) -> TaskOut:
        goals = goals_jit(state, action)
        qpos_np = np.asarray(state.qpos, np.float64)
        sols = {}
        for side in ee_sides:
            gp, gq = goals[side]
            # native C++ TRF when built (solvers/ik_host.solve_host), the
            # numpy f64 twin otherwise — identical contract either way
            q_sol, q_scrib = solve_host(
                qpos_np, np.asarray(gp, np.float64),
                np.asarray(gq, np.float64), q_home_np, qpos_np,
                model=model, q_mask=masks[side],
                site_name=f"ee{side}_site",
            )
            sols[side] = (q_sol, q_scrib)
        return core_jit(state, action, sols)

    # the traceable pieces, for tests that trace jitted programs
    # (tests/test_no_device_closures.py walks these when present)
    step_fn.jit_parts = (goals_jit, core_jit)
    return jax.jit(reset_fn), step_fn, model


def step_fn_fused(step_core):
    """Single-program step for configs without host IK."""
    def step_fn(state, action):
        return step_core(state, action, None)

    return step_fn
