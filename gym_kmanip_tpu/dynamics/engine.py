"""Forward dynamics step: PD actuators + bias + contacts, semi-implicit Euler.

JAX replacement for the reference's `physics.step()` pipeline
(dm_control -> native MuJoCo mj_step, /root/reference/gym_kmanip/env_sim.py:
196-210): one 20 ms control step = `lax.scan` over 10 substeps of 2 ms
(CONTROL_TIMESTEP / PHYSICS_TIMESTEP, reference __init__.py:30 + MuJoCo
default timestep).

The actuator model mirrors MuJoCo `<position>` servos (arm_r.xml:44-55,
torso.xml:113-135): tau = kp * (ctrl - q), clamped to forcerange. The
reference XMLs specify no joint damping; a small engine damping plus the
XML frictionloss keeps the undamped kp=1000 servos well-behaved under
explicit integration (documented engine regularization, not reference
behavior).

Everything is a pure function of (model, state, ctrl); model is static and
closed over by jit, state/ctrl vmap over rollout batches.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import contacts
from gym_kmanip_tpu.dynamics.state import SimState, StepAux
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.ops import kinematics as kin
from gym_kmanip_tpu.ops import linalg
from gym_kmanip_tpu.utils import rotations as rot
from gym_kmanip_tpu.utils.precision import highest_precision

_CUBE_INV_MASS = 1.0 / k.CUBE_MASS
_CUBE_INV_INERTIA = 1.0 / k.CUBE_DIAG_INERTIA  # isotropic (scene.xml:16)


def _tip_state(
    model: RobotModel, xpos, xquat, axis_w, qvel
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """World fingertip positions, velocities, and translational Jacobians."""
    tips = model.fingertips
    if not tips:  # custom robots without gripper collision spheres
        z = jnp.zeros((0, 3), dtype=qvel.dtype)
        return z, z, jnp.zeros((0, 3, model.nq), dtype=qvel.dtype), jnp.zeros(
            (0,), dtype=qvel.dtype
        )
    pos, jac, rad = [], [], []
    for t in tips:
        p = xpos[t.parent] + rot.quat_rotate(
            xquat[t.parent], jnp.asarray(t.pos, dtype=qvel.dtype)
        )
        jp, _ = kin.point_jacobian(model, xpos, axis_w, p, t.parent)
        pos.append(p)
        jac.append(jp)
        rad.append(t.radius)
    pos = jnp.stack(pos)  # (T,3)
    jac = jnp.stack(jac)  # (T,3,nq)
    vel = jac @ qvel  # (T,3)
    return pos, vel, jac, jnp.asarray(rad, dtype=qvel.dtype)


def constraint_qacc(model: RobotModel, qpos, qvel, qacc0, Mdiag, solve, dt):
    """Joint limits + dof frictionloss as a force-space dual iteration.

    MuJoCo solves limits/friction as CONSTRAINT FORCES through the full
    mass matrix: a limit force on one joint accelerates every coupled
    joint through M^-1 (e.g. the torso home pose parks left x8_1 at -1.70
    vs lo=-1.5708; its ~23 Nm return force swings the whole left arm —
    a diagonal qacc clamp misses 40% of the neighbor acceleration).
    This is MuJoCo's own dual PGS shape, Jacobi-style, J = identity rows:

      limits  (solref 0.02,1): target aref = kappa*viol - beta*qvel,
              force one-sided, impedance-weighted (solimp dmax = 0.95)
      friction: target qvel = 0 at end of step (a = -v/dt), |f| <= fl
                (dry friction that holds static joints exactly — the
                reference gripper sliders, fl = 30, never see the ~14 N
                a tanh viscous model injects at mm/s velocities)

    Each sweep updates the force estimate diagonally (effective-mass scale
    M_ii) and re-propagates through the factored solve (O(n^2) per sweep,
    CONSTRAINT_ITERS sweeps, factorization reused). Converges to MuJoCo's
    forces within a few % in 3 sweeps (the coupling spectral radius of
    these models is ~0.2).

    `solve(b)` must solve M x = b reusing the substep's factorization."""
    lo = jnp.asarray(model.jnt_range[:, 0], dtype=qpos.dtype)
    hi = jnp.asarray(model.jnt_range[:, 1], dtype=qpos.dtype)
    fl = jnp.asarray(model.jnt_frictionloss, dtype=qpos.dtype)
    viol_lo = lo - qpos
    viol_hi = qpos - hi
    aref_lo = k.LIMIT_KAPPA * viol_lo - k.LIMIT_BETA * qvel
    aref_hi = -k.LIMIT_KAPPA * viol_hi - k.LIMIT_BETA * qvel
    d = k.LIMIT_IMPEDANCE

    f_fric = jnp.zeros_like(qacc0)
    f_lo = jnp.zeros_like(qacc0)
    f_hi = jnp.zeros_like(qacc0)
    qacc = qacc0
    d_fr = k.FRICTION_IMPEDANCE
    for _ in range(k.CONSTRAINT_ITERS):
        # regularized dry friction (MuJoCo solreffriction semantics):
        # PGS step on min ||A f - (aref - a0)||^2 + R f^2 with
        # R = (1-d)/d * A  =>  f += d*M*(aref - a) - (1-d)*f, clipped to
        # +-frictionloss. Under-bound applied forces leave steady creep
        # v = -(1-d)/(d*M*beta) * f (the reference gripper NEEDS this:
        # kp*range = 6.8 N < fl = 30 would latch forever under exact dry
        # friction; golden trace tests/golden/slider_friction_trace.npz)
        f_fric = jnp.clip(
            f_fric
            + d_fr * Mdiag * (-k.FRICTION_BETA * qvel - qacc)
            - (1.0 - d_fr) * f_fric,
            -fl, fl,
        )
        f_lo = jnp.where(
            viol_lo > 0,
            jnp.maximum(f_lo + d * Mdiag * (aref_lo - qacc), 0.0),
            0.0,
        )
        f_hi = jnp.where(
            viol_hi > 0,
            jnp.minimum(f_hi + d * Mdiag * (aref_hi - qacc), 0.0),
            0.0,
        )
        qacc = qacc0 + solve(f_fric + f_lo + f_hi)
    return qacc


@highest_precision
def substep(
    model: RobotModel,
    state: SimState,
    dt: float,
    contact: bool = True,
    unrolled_solve: bool = True,
    implicit_actuation: bool = False,
) -> Tuple[SimState, jax.Array]:
    """One physics substep. Returns (new_state, (touch, xpos, xquat)).

    `contact` is a static flag: False compiles a free-space program (no
    cube/table/fingertip forces) -- used for reach-only MPC rollouts and
    for dynamics parity tests against contact-free MuJoCo traces.

    `unrolled_solve` picks the mass-matrix solve: the trace-time-unrolled
    Cholesky (ops/linalg), which XLA fuses into elementwise loops over a
    vmapped rollout batch, or the lowered lapack-style routine, whose
    smaller graph differentiating callers (iLQR's jacfwd linearization)
    use to keep compile times sane.

    `implicit_actuation` applies the "stable PD" discretization (Tan et al.):
    the servo stiffness is integrated implicitly by adding dt^2 diag(kp) to
    the mass matrix and dt kp v to the force. At the env's 2 ms substeps the
    explicit servos are stable (dt*w <= 0.6) and this stays False for exact
    MuJoCo parity; the MPC fast path integrates at dt = 20 ms where kp=1000
    on low-inertia distal joints gives dt*w ~ 4-6 (explicitly UNSTABLE), so
    rollouts turn it on.
    """
    q, v = state.qpos, state.qvel

    # single forward pass: world frames + bias forces (RNEA)
    xpos, xquat, axis_w, tau_bias = kin.rnea_terms(model, q, v)
    tip_pos, tip_vel, tip_jac, tip_rad = _tip_state(model, xpos, xquat, axis_w, v)

    if contact:
        con = contacts.contact_forces(
            tip_pos,
            tip_vel,
            tip_rad,
            state.cube_pos,
            state.cube_quat,
            state.cube_linvel,
            state.cube_angvel,
        )
    else:
        con = contacts.ContactOut(
            force_cube=jnp.zeros(3, dtype=q.dtype),
            torque_cube=jnp.zeros(3, dtype=q.dtype),
            tip_forces=jnp.zeros_like(tip_pos),
            touch_tip=jnp.zeros(tip_pos.shape[0], dtype=bool),
            touch_table=jnp.asarray(False),
        )

    # ---- robot ----
    kp = jnp.asarray(model.actuator_kp, dtype=q.dtype)
    frange = jnp.asarray(model.force_range, dtype=q.dtype)
    tau_act = jnp.clip(kp * (state.ctrl - q[: model.nu]), frange[:, 0], frange[:, 1])
    tau_act = jnp.zeros_like(q).at[: model.nu].set(tau_act)

    # frictionloss is applied post-solve as a dry-friction projection (see
    # below); only the engine-regularization damping enters tau here
    tau_fric = -k.JOINT_DAMPING * v
    tau_contact = jnp.einsum("taj,ta->j", tip_jac, con.tip_forces)

    tau = tau_act + tau_fric + tau_contact - tau_bias
    M = kin.mass_matrix_from_frames(model, xpos, xquat, axis_w)
    # implicit joint damping a la MuJoCo's Euler integrator (eulerdamp):
    # solve (M + h diag(B)) qacc = tau with the damping force kept in tau
    M = M + dt * k.JOINT_DAMPING * jnp.eye(model.nq, dtype=q.dtype)
    if implicit_actuation:
        kp_full = jnp.zeros(model.nq, dtype=q.dtype).at[: model.nu].set(kp)
        tau = tau - dt * kp_full * v
        M = M + dt * dt * jnp.diag(kp_full)
    if unrolled_solve:
        Lrows = linalg.cholesky_factor_unrolled(M)
        solve = partial(linalg.cholesky_substitute, Lrows)
    else:
        L = jnp.linalg.cholesky(M)
        solve = partial(jax.scipy.linalg.cho_solve, (L, True))
    qacc = solve(tau)
    qacc = constraint_qacc(model, q, v, qacc, jnp.diagonal(M), solve, dt)

    v_new = v + dt * qacc
    q_new = q + dt * v_new
    # wide safety clamp only (coarse-dt MPC rollouts); the soft limit above
    # is the physical model and the 2 ms plant never reaches this margin
    lo = jnp.asarray(model.jnt_range[:, 0], dtype=q.dtype) - k.LIMIT_SAFETY_MARGIN
    hi = jnp.asarray(model.jnt_range[:, 1], dtype=q.dtype) + k.LIMIT_SAFETY_MARGIN
    q_clamped = jnp.clip(q_new, lo, hi)
    v_new = jnp.where(
        ((q_new > hi) & (v_new > 0)) | ((q_new < lo) & (v_new < 0)), 0.0, v_new
    )

    # ---- cube (free body) ----
    g = jnp.asarray(k.GRAVITY, dtype=q.dtype)
    linvel = state.cube_linvel + dt * (con.force_cube * _CUBE_INV_MASS + g)
    angvel = state.cube_angvel + dt * (con.torque_cube * _CUBE_INV_INERTIA)
    # cube_joint frictionloss 0.01 (scene.xml:15): dry friction, same
    # bounded velocity-zeroing projection as the robot joints
    cap_l = dt * k.CUBE_FRICTIONLOSS * _CUBE_INV_MASS
    cap_a = dt * k.CUBE_FRICTIONLOSS * _CUBE_INV_INERTIA
    linvel = linvel + jnp.clip(-linvel, -cap_l, cap_l)
    angvel = angvel + jnp.clip(-angvel, -cap_a, cap_a)
    # energy cap (see constants.CUBE_MAX_LINVEL)
    linvel = jnp.clip(linvel, -k.CUBE_MAX_LINVEL, k.CUBE_MAX_LINVEL)
    angvel = jnp.clip(angvel, -k.CUBE_MAX_ANGVEL, k.CUBE_MAX_ANGVEL)
    cube_pos = state.cube_pos + dt * linvel
    cube_quat = rot.quat_integrate(state.cube_quat, angvel, dt)

    new = SimState(
        qpos=q_clamped,
        qvel=v_new,
        ctrl=state.ctrl,
        cube_pos=cube_pos,
        cube_quat=cube_quat,
        cube_linvel=linvel,
        cube_angvel=angvel,
        time=state.time + dt,
    )
    # aux: (touch flags, pre-step world frames). Frames correspond to the
    # state this substep advanced FROM; callers needing exact end-of-step
    # sites (the env path) run one extra FK, while MPC rollouts reuse them
    # with a one-step shift (mpc/rollout.py).
    return new, (con.touch_tip, xpos, xquat)


@highest_precision
def control_step(
    model: RobotModel,
    state: SimState,
    ctrl: jax.Array,
    qpos_force: jax.Array | None = None,
) -> Tuple[SimState, StepAux]:
    """One 20 ms control step = N_SUBSTEPS scanned physics substeps.

    `ctrl` is the already-decoded actuator target vector (the env layer does
    action decoding + the exponential ctrl filter, mirroring
    KManipTask.before_step, env_sim.py:38-108).

    `qpos_force` (env parity): dm_control's split-step scheme runs
    `mj_step2` first, so the FIRST substep's forces (actuator lengths, bias,
    mass matrix, contacts) come from the mj_step1 kinematics of the state
    BEFORE the task's before_step scribbled IK iterates into qpos — while
    integration proceeds from the scribbled qpos. Passing the pre-decode
    qpos here reproduces that: substep 1 computes qacc at `qpos_force` and
    rebases the position update onto `state.qpos`; substeps 2..N are
    coherent, exactly like dm_control's subsequent mj_step2+mj_step1 pairs.
    """
    state = state._replace(ctrl=jnp.asarray(ctrl, dtype=state.qpos.dtype))

    def body(s, _):
        s2, (touch, _xp, _xq) = substep(model, s, k.PHYSICS_TIMESTEP)
        return s2, touch

    n_scan = k.N_SUBSTEPS
    touch_first = None
    if qpos_force is not None:
        q_tele = state.qpos
        s1, (touch_first, _xp, _xq) = substep(
            model,
            state._replace(qpos=jnp.asarray(qpos_force, dtype=state.qpos.dtype)),
            k.PHYSICS_TIMESTEP,
        )
        lo = jnp.asarray(model.jnt_range[:, 0], dtype=q_tele.dtype) - k.LIMIT_SAFETY_MARGIN
        hi = jnp.asarray(model.jnt_range[:, 1], dtype=q_tele.dtype) + k.LIMIT_SAFETY_MARGIN
        q_rebased = jnp.clip(q_tele + k.PHYSICS_TIMESTEP * s1.qvel, lo, hi)
        state = s1._replace(qpos=q_rebased)
        n_scan = k.N_SUBSTEPS - 1

    state, touches = jax.lax.scan(body, state, None, length=n_scan)
    if touch_first is not None:
        touches = jnp.concatenate([touch_first[None], touches], axis=0)

    # diagnostics at the final state (the reference reads contacts/xpos after
    # the substep loop, env_sim.py:163-178)
    xpos, xquat, _ = kin.fk(model, state.qpos)
    sp, sq = [], []
    for s in model.sites:
        p, qu = kin.site_pose(model, xpos, xquat, s.name)
        sp.append(p)
        sq.append(qu)
    touch_last = touches[-1]  # (T,)
    sides_r = jnp.asarray([t.side == "r" for t in model.fingertips], dtype=bool)
    sides_l = jnp.asarray([t.side == "l" for t in model.fingertips], dtype=bool)

    # cube-table touch recomputed at final state
    _, _, touch_table = contacts.cube_table(
        state.cube_pos, state.cube_quat, state.cube_linvel, state.cube_angvel
    )

    tip_pos = _tips_from_frames(model, xpos, xquat)
    aux = StepAux(
        touch_r=jnp.any(touch_last & sides_r),
        touch_l=jnp.any(touch_last & sides_l),
        touch_table=touch_table,
        site_pos=jnp.stack(sp),
        site_quat=jnp.stack(sq),
        qfrc_contact=jnp.zeros_like(state.qvel),
        tip_pos=tip_pos,
    )
    return state, aux


def _tips_from_frames(model: RobotModel, xpos, xquat):
    """World fingertip centers from joint frames (no Jacobians)."""
    if not model.fingertips:
        return jnp.zeros(xpos.shape[:-2] + (0, 3), dtype=xpos.dtype)
    return jnp.stack(
        [
            xpos[..., t.parent, :]
            + rot.quat_rotate(
                xquat[..., t.parent, :], jnp.asarray(t.pos, dtype=xpos.dtype)
            )
            for t in model.fingertips
        ],
        axis=-2,
    )


def make_control_step(model: RobotModel):
    """Jitted single-env control step closed over a static model."""
    return jax.jit(partial(control_step, model))
