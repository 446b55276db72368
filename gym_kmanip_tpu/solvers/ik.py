"""Batched damped least-squares IK in pure JAX.

JAX replacement for the reference's scipy-TRF IK
(/root/reference/gym_kmanip/ik_mujoco.py:100-155). The residual is the same
stack the reference builds (ik_mujoco.py:20-53):

    r(q) = [ ee_pos(q) - goal_pos                      (3,)
             IK_RES_RAD * subQuat(goal_orn, ee_orn(q)) (3,)
             IK_RES_REG_PREV * (q - q_prev)            (n,)
             IK_RES_REG_HOME * (q - q_home)            (n,) ]

so the least-squares minimum is the reference's. Two solvers share it:

- ``ik_trf`` (the env path): a full JAX port of scipy's TRF trust-region
  algorithm (solvers/trf.py) driven by the reference's ANALYTIC Jacobian —
  including its deliberate inconsistency (regularization rows at
  IK_JAC_REG=9e-3 while the residual uses 6e-3/2e-6, ik_mujoco.py:95-97).
  Replicating both the trust-region dynamics and the inconsistent Jacobian
  is what pins down the same point on the redundant-arm solution manifold
  the reference lands on; with the exact jacfwd Jacobian instead, scipy
  itself drifts 4.7e-2 rad from the reference over 20 env steps (measured,
  tools/exp_ik_parity.py), because the stationary point J_wrong^T r = 0
  moves.
- ``ik`` (the MPC inner loop): a fixed-budget Levenberg-Marquardt iteration
  with bound projection and the exact jacfwd Jacobian — cheaper, fully
  scan-based, accurate to well below actuator resolution for warm-started
  receding-horizon use.

Neither solver calls back to the host; both vmap over arbitrary batches of
(qpos, goals).
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.ops import kinematics as kin
from gym_kmanip_tpu.utils import rotations as rot
from gym_kmanip_tpu.utils.precision import highest_precision


class IKResult(NamedTuple):
    qpos: jax.Array  # (n,) solved joint positions (masked subset)
    residual_norm: jax.Array  # () final |r|
    iters_used: jax.Array  # () int


def _residual(
    model: RobotModel,
    q_masked: jax.Array,
    qpos_full: jax.Array,
    goal_pos: jax.Array,
    goal_orn: jax.Array,
    q_home: jax.Array,
    q_prev: jax.Array,
    q_mask: Tuple[int, ...],
    site_name: str,
) -> jax.Array:
    mask = jnp.asarray(q_mask)
    q_full = qpos_full.at[mask].set(q_masked)
    xpos, xquat, _ = kin.fk(model, q_full)
    ee_pos, ee_quat = kin.site_pose(model, xpos, xquat, site_name)
    res_pos = ee_pos - goal_pos
    res_quat = k.IK_RES_RAD * rot.quat_sub(goal_orn, ee_quat)
    res_prev = k.IK_RES_REG_PREV * (q_masked - q_prev)
    res_home = k.IK_RES_REG_HOME * (q_masked - q_home)
    return jnp.concatenate([res_pos, res_quat, res_prev, res_home])


def _quat_from_tangent(e: jax.Array) -> jax.Array:
    """MuJoCo local tangent convention: q' = q * exp([0, e/2])."""
    angle = jnp.sqrt(jnp.sum(e * e) + 1e-24)
    axis = e / angle
    half = 0.5 * angle
    return jnp.concatenate([jnp.cos(half)[None], jnp.sin(half) * axis])


def _subquat_jac_b(qa: jax.Array, qb: jax.Array) -> jax.Array:
    """Db = d subQuat(qa, qb*exp(e/2)) / de at e=0 (mjd_subQuat's Db output,
    used by the reference at ik_mujoco.py:83-86)."""
    f = lambda e: rot.quat_sub(qa, rot.quat_mul(qb, _quat_from_tangent(e)))
    return jax.jacfwd(f)(jnp.zeros(3, dtype=qa.dtype))


def reference_jacobian(
    model: RobotModel,
    q_masked: jax.Array,
    qpos_full: jax.Array,
    goal_orn: jax.Array,
    q_mask: Tuple[int, ...],
    site_name: str,
) -> jax.Array:
    """The reference's analytic IK Jacobian, quirks included (ik_jac,
    ik_mujoco.py:56-97): position rows from the site Jacobian, quaternion
    rows = IK_JAC_RAD * Db^T R^T jacr (Db transposed, R = the EE rotation the
    reference names "target_mat"), and BOTH regularization blocks at
    IK_JAC_REG * I — inconsistent with the residual's 6e-3/2e-6 weights.
    This inconsistency shifts the solver's stationary point; we reproduce it
    because the reference's joint trajectories are defined by it."""
    mask = jnp.asarray(q_mask)
    q_full = qpos_full.at[mask].set(q_masked)
    xpos, xquat, axis_w = kin.fk(model, q_full)
    s = model.site(site_name)
    ee_pos, ee_quat = kin.site_pose(model, xpos, xquat, site_name)
    jacp, jacr = kin.point_jacobian(model, xpos, axis_w, ee_pos, s.parent)
    R = rot.quat_to_mat(ee_quat)
    Db = _subquat_jac_b(goal_orn, ee_quat)
    jac_quat = (k.IK_JAC_RAD * Db.T @ R.T) @ jacr
    n = len(q_mask)
    jac_reg = k.IK_JAC_REG * jnp.eye(n, dtype=q_masked.dtype)
    return jnp.vstack([jacp[:, mask], jac_quat[:, mask], jac_reg, jac_reg])


@highest_precision
def ik_trf(
    model: RobotModel,
    qpos_full: jax.Array,
    goal_pos: jax.Array,
    goal_orn: jax.Array,
    q_pos_home_full: jax.Array,
    q_pos_prev_full: jax.Array,
    *,
    q_mask: Tuple[int, ...],
    site_name: str,
) -> Tuple[jax.Array, jax.Array]:
    """Reference-parity IK: scipy-TRF semantics (solvers/trf.py) with the
    reference's analytic Jacobian and default tolerances, matching
    least_squares(ik_res, q0, jac=ik_jac, bounds=jnt_range) at
    ik_mujoco.py:129-135. Post-solve behavior mirrors ik(): the reference's
    velocity clip is a no-op (clips the solution around itself,
    ik_mujoco.py:139-145), the joint-range clip is kept, and NaN results fall
    back to the warm start (the try/except-keep-previous path,
    ik_mujoco.py:128-138).

    Returns ``(q_sol, q_scribble)``. q_sol is the clipped solution the
    reference writes into ctrl. q_scribble is the behavior-defining side
    effect the reference leaves behind: ik_res/ik_jac write every candidate
    q into the LIVE physics.data.qpos and never restore it
    (ik_mujoco.py:33-34, 68-69), so after before_step the masked joints sit
    at the last point scipy evaluated — the solution after a normal exit,
    the REJECTED trial point after a trust-radius-collapse exit, and the
    untouched warm start when scipy's bounds check raises before any
    evaluation. The env step must assign qpos[mask] = q_scribble before
    integrating to match the reference's dynamics (it effectively teleports
    the arm each control step; the kp=1000 servos then only mop up the
    residual)."""
    from gym_kmanip_tpu.solvers.trf import least_squares_trf

    mask = jnp.asarray(q_mask)
    lo = jnp.asarray(model.jnt_range[list(q_mask), 0], dtype=qpos_full.dtype)
    hi = jnp.asarray(model.jnt_range[list(q_mask), 1], dtype=qpos_full.dtype)
    q0 = qpos_full[mask]

    res_fn = partial(
        _residual,
        model,
        qpos_full=qpos_full,
        goal_pos=goal_pos,
        goal_orn=goal_orn,
        q_home=q_pos_home_full[mask],
        q_prev=q_pos_prev_full[mask],
        q_mask=q_mask,
        site_name=site_name,
    )
    jac_fn = partial(
        reference_jacobian,
        model,
        qpos_full=qpos_full,
        goal_orn=goal_orn,
        q_mask=q_mask,
        site_name=site_name,
    )

    out = least_squares_trf(res_fn, jac_fn, q0, lo, hi)
    nan = jnp.isnan(out.x).any()
    q = jnp.where(nan, q0, out.x)
    scribble = jnp.where(nan | jnp.isnan(out.x_last_eval).any(), q0, out.x_last_eval)
    # scipy raises ValueError when the warm start is outside the bounds
    # (joints can physically exceed their soft limits); the reference
    # catches it and keeps the CURRENT qpos ("IK failed: Initial guess is
    # outside of provided bounds", ik_mujoco.py:137-138), which the final
    # clip then projects into range — and since the raise happens before any
    # residual evaluation, data.qpos is never scribbled either.
    out_of_bounds = jnp.any((q0 < lo) | (q0 > hi))
    q = jnp.where(out_of_bounds, q0, q)
    scribble = jnp.where(out_of_bounds, q0, scribble)
    return jnp.clip(q, lo, hi), scribble


@highest_precision
def ik(
    model: RobotModel,
    qpos_full: jax.Array,
    goal_pos: jax.Array,
    goal_orn: jax.Array,
    q_pos_home_full: jax.Array,
    q_pos_prev_full: jax.Array,
    *,
    q_mask: Tuple[int, ...],
    site_name: str,
    iters: int = k.IK_MAX_ITERS,
) -> jax.Array:
    """Solve IK for the masked joints; returns the solved masked q.

    Mirrors ik() at ik_mujoco.py:100-155 including its post-solve behavior:
    the reference's "velocity limit" clip is a no-op (it clips the solution
    around itself, ik_mujoco.py:139-145) so only the joint-range clip is
    applied. Solver failure cannot occur here (no host exceptions); NaN
    guards keep the previous solution, matching the reference's
    try/except-keep-previous fallback (ik_mujoco.py:128-138).
    """
    mask = jnp.asarray(q_mask)
    lo = jnp.asarray(model.jnt_range[list(q_mask), 0], dtype=qpos_full.dtype)
    hi = jnp.asarray(model.jnt_range[list(q_mask), 1], dtype=qpos_full.dtype)
    q0 = qpos_full[mask]
    q_home = q_pos_home_full[mask]
    q_prev = q_pos_prev_full[mask]

    res_fn = partial(
        _residual,
        model,
        qpos_full=qpos_full,
        goal_pos=goal_pos,
        goal_orn=goal_orn,
        q_home=q_home,
        q_prev=q_prev,
        q_mask=q_mask,
        site_name=site_name,
    )

    n = len(q_mask)
    eye = jnp.eye(n, dtype=qpos_full.dtype)

    def body(carry, _):
        q, lam = carry
        r = res_fn(q)
        J = jax.jacfwd(res_fn)(q)
        H = J.T @ J + lam * eye
        g = J.T @ r
        dq = -jax.scipy.linalg.solve(H, g, assume_a="pos")
        q_new = jnp.clip(q + dq, lo, hi)
        # simple trust logic: shrink damping on improvement, grow otherwise
        c_old = jnp.sum(r * r)
        r_new = res_fn(q_new)
        c_new = jnp.sum(r_new * r_new)
        improved = c_new < c_old
        q = jnp.where(improved, q_new, q)
        lam = jnp.where(improved, jnp.maximum(lam * 0.5, 1e-8), lam * 4.0)
        return (q, lam), None

    (q, _), _ = jax.lax.scan(body, (q0, jnp.asarray(1e-4, dtype=q0.dtype)), None, length=iters)

    # NaN guard: keep the warm start (reference keeps previous on failure)
    q = jnp.where(jnp.isnan(q).any(), q0, q)
    # joint position limit clip (ik_mujoco.py:146-151)
    return jnp.clip(q, lo, hi)
