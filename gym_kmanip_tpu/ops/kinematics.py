"""Batched forward kinematics and Jacobians in pure JAX.

JAX replacement for the reference's MuJoCo C calls
(mj_kinematics / mj_comPos / mj_jacSite at
/root/reference/gym_kmanip/ik_mujoco.py:35,68-80).

Design: the kinematic tree is static (parents have lower indices), so FK is
an unrolled composition over at most 20 joints -- XLA fuses it into a handful
of vector ops. Everything broadcasts over arbitrary leading batch dims via
vmap, which is how thousands of MPC rollouts share one compiled program.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu.models.spec import HINGE, SLIDE, RobotModel
from gym_kmanip_tpu.utils import rotations as rot


def fk(model: RobotModel, qpos: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Forward kinematics for one configuration.

    Args:
      qpos: (nq,) joint positions.
    Returns:
      xpos: (nq, 3) world position of each joint frame origin
      xquat: (nq, 4) world orientation of each joint frame
      axis_w: (nq, 3) world-frame joint axis (z of the joint frame)
    """
    jp = jnp.asarray(model.jnt_pos, dtype=qpos.dtype)
    jq = jnp.asarray(model.jnt_quat, dtype=qpos.dtype)
    xpos = []
    xquat = []
    for i in range(model.nq):
        par = int(model.parent[i])
        if par < 0:
            p_par = jnp.zeros(3, dtype=qpos.dtype)
            q_par = jnp.array([1.0, 0, 0, 0], dtype=qpos.dtype)
        else:
            p_par, q_par = xpos[par], xquat[par]
        p = p_par + rot.quat_rotate(q_par, jp[i])
        q = rot.quat_mul(q_par, jq[i])
        if int(model.jnt_type[i]) == HINGE:
            # rotate about local z by qpos[i]
            half = 0.5 * qpos[i]
            qz = jnp.stack(
                [jnp.cos(half), jnp.zeros_like(half), jnp.zeros_like(half), jnp.sin(half)]
            )
            q = rot.quat_mul(q, qz)
        else:  # SLIDE: translate along local z
            p = p + rot.quat_rotate(q, jnp.array([0.0, 0, 1.0], dtype=qpos.dtype) * qpos[i])
        xpos.append(p)
        xquat.append(q)
    xpos = jnp.stack(xpos)
    xquat = jnp.stack(xquat)
    axis_w = rot.quat_rotate(xquat, jnp.broadcast_to(jnp.array([0.0, 0, 1.0], dtype=qpos.dtype), (model.nq, 3)))
    return xpos, xquat, axis_w


def site_pose(
    model: RobotModel, xpos: jax.Array, xquat: jax.Array, site_name: str
) -> Tuple[jax.Array, jax.Array]:
    """World pose of a named site. Equivalent to physics.data.site(x).xpos/xmat."""
    s = model.site(site_name)
    p = xpos[s.parent] + rot.quat_rotate(xquat[s.parent], jnp.asarray(s.pos, dtype=xpos.dtype))
    q = rot.quat_mul(xquat[s.parent], jnp.asarray(s.quat, dtype=xpos.dtype))
    return p, q


def all_site_poses(
    model: RobotModel, xpos: jax.Array, xquat: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """World poses of ALL sites at once: ((S, 3) pos, (S, 4) quat wxyz).

    Same math as `site_pose` per site, but batched into one gather + one
    quat_rotate + one quat_mul so the rollout hot loop (mpc/rollout.py)
    emits a constant number of HLO ops regardless of site count — the
    per-site Python loop was pure op-dispatch latency inside `lax.scan`.
    Row order matches `model.sites` / `model.site_index`.
    """
    parents = jnp.asarray([s.parent for s in model.sites], dtype=jnp.int32)
    spos = jnp.asarray(
        np.stack([np.asarray(s.pos) for s in model.sites]), dtype=xpos.dtype
    )
    squat = jnp.asarray(
        np.stack([np.asarray(s.quat) for s in model.sites]), dtype=xpos.dtype
    )
    pp = xpos[..., parents, :]  # (..., S, 3)
    pq = xquat[..., parents, :]  # (..., S, 4)
    return pp + rot.quat_rotate(pq, spos), rot.quat_mul(pq, squat)


def point_jacobian(
    model: RobotModel,
    xpos: jax.Array,
    axis_w: jax.Array,
    point: jax.Array,
    attach_joint: int,
) -> Tuple[jax.Array, jax.Array]:
    """Translational + rotational Jacobian of a world point rigidly attached
    to `attach_joint`'s body. Equivalent to mj_jacSite (ik_mujoco.py:74).

    Returns (jacp, jacr), each (3, nq).
    """
    anc = jnp.asarray(model.ancestors[attach_joint], dtype=xpos.dtype)  # (nq,)
    is_slide = jnp.asarray(model.jnt_type == SLIDE, dtype=xpos.dtype)[:, None]
    lever = jnp.cross(axis_w, point[None, :] - xpos)  # (nq, 3)
    jacp = anc[:, None] * jnp.where(is_slide > 0, axis_w, lever)  # (nq,3)
    jacr = anc[:, None] * (1.0 - is_slide) * axis_w
    return jacp.T, jacr.T


def body_jacobians(
    model: RobotModel, xpos: jax.Array, xquat: jax.Array, axis_w: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """COM Jacobians for every joint body, vectorized over bodies and joints.

    Returns:
      com_w: (nq, 3) world COM of each body
      jv: (nq, 3, nq) translational Jacobians
      jw: (nq, 3, nq) rotational Jacobians
    """
    com = jnp.asarray(model.body_com, dtype=xpos.dtype)
    com_w = xpos + rot.quat_rotate(xquat, com)  # (nq,3)
    anc = jnp.asarray(model.ancestors, dtype=xpos.dtype)  # (nq,nq) body i, joint j
    is_slide = jnp.asarray(model.jnt_type == SLIDE, dtype=xpos.dtype)  # (nq,)
    # lever[i,j] = axis_j x (com_i - p_j)
    diff = com_w[:, None, :] - xpos[None, :, :]  # (nbody, njnt, 3)
    lever = jnp.cross(jnp.broadcast_to(axis_w[None], diff.shape), diff)
    jv = anc[:, :, None] * jnp.where(
        is_slide[None, :, None] > 0, axis_w[None], lever
    )  # (nbody, njnt, 3)
    jw = anc[:, :, None] * (1.0 - is_slide)[None, :, None] * axis_w[None]
    return com_w, jv.transpose(0, 2, 1), jw.transpose(0, 2, 1)


def mass_matrix(model: RobotModel, qpos: jax.Array) -> jax.Array:
    """Joint-space inertia matrix M(q) via COM-Jacobian contraction.

    M = sum_i m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i + armature.
    Dense einsum formulation: O(n^2) contractions, chosen over recursive
    CRBA because rollout batches (K x H) turn these tiny contractions into
    batched GEMMs.
    """
    xpos, xquat, axis_w = fk(model, qpos)
    _, jv, jw = body_jacobians(model, xpos, xquat, axis_w)
    m = jnp.asarray(model.body_mass, dtype=qpos.dtype)  # (nq,)
    I_diag = jnp.asarray(model.body_inertia, dtype=qpos.dtype)  # (nq,3)
    R = rot.quat_to_mat(xquat)  # (nq,3,3)
    Iw = jnp.einsum("iab,ib,icb->iac", R, I_diag, R)  # R diag(I) R^T
    M = jnp.einsum("iaj,i,iak->jk", jv, m, jv) + jnp.einsum(
        "iaj,iab,ibk->jk", jw, Iw, jw
    )
    return M + jnp.diag(jnp.asarray(model.armature, dtype=qpos.dtype))


def gravity_potential(model: RobotModel, qpos: jax.Array, g: float = 9.81) -> jax.Array:
    """Potential energy U(q) = sum_i m_i g z_com_i."""
    xpos, xquat, _ = fk(model, qpos)
    com = jnp.asarray(model.body_com, dtype=qpos.dtype)
    com_w = xpos + rot.quat_rotate(xquat, com)
    m = jnp.asarray(model.body_mass, dtype=qpos.dtype)
    return g * jnp.sum(m * com_w[:, 2])


def bias_forces_ad(model: RobotModel, qpos: jax.Array, qvel: jax.Array) -> jax.Array:
    """qfrc_bias = C(q,v)v + g(q), via autodiff of the Lagrangian.

    Coriolis: C v = dM/dt v - 1/2 d(v^T M v)/dq, with dM/dt v computed as a
    single jvp of q -> M(q) v along qdot. Gravity: dU/dq. Kept as the slow
    test oracle for the hand-rolled RNEA below (exactness follows from FK
    exactness); the engine uses `bias_forces`.
    """
    Mv = lambda q: mass_matrix(model, q) @ qvel
    dM_dt_v = jax.jvp(Mv, (qpos,), (qvel,))[1]
    dT_dq = jax.grad(lambda q: 0.5 * qvel @ mass_matrix(model, q) @ qvel)(qpos)
    dU_dq = jax.grad(lambda q: gravity_potential(model, q))(qpos)
    return dM_dt_v - dT_dq + dU_dq


def bias_forces(model: RobotModel, qpos: jax.Array, qvel: jax.Array) -> jax.Array:
    """qfrc_bias = C(q,v)v + g(q); see `rnea_terms`."""
    return rnea_terms(model, qpos, qvel)[3]


def rnea_terms(
    model: RobotModel, qpos: jax.Array, qvel: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One forward pass returning (xpos, xquat, axis_w, qfrc_bias).

    qfrc_bias = C(q,v)v + g(q) via recursive Newton-Euler with qacc = 0.
    Explicit unrolled two-pass recursion over the (static, <=20 joint) tree:
    ~100x cheaper than the AD-of-Lagrangian formulation because it avoids
    reverse-mode through the FK unroll. Gravity enters as a fictitious base
    acceleration -g (standard RNEA trick). Replaces the bias portion of
    MuJoCo's mj_step smooth-dynamics stage (reference env_sim.py:196-200).

    Returning the world kinematics alongside the bias lets the engine run
    FK exactly once per substep (it is also needed for contacts, Jacobians
    and the mass matrix).
    """
    dt = qpos.dtype
    jp = jnp.asarray(model.jnt_pos, dtype=dt)
    jq = jnp.asarray(model.jnt_quat, dtype=dt)
    g = jnp.array([0.0, 0.0, -9.81], dtype=dt)

    # ---- forward pass: world kinematics, velocities, accelerations ----
    x, q, axis = [], [], []  # joint origin, orientation, world axis
    w, v = [], []  # body angular / joint-origin linear velocity
    alpha, a = [], []  # angular / linear acceleration (qacc = 0)
    z3 = jnp.zeros(3, dtype=dt)
    for i in range(model.nq):
        par = int(model.parent[i])
        if par < 0:
            xp, qp = z3, jnp.array([1.0, 0, 0, 0], dtype=dt)
            wp, vp, alp, ap = z3, z3, z3, -g  # base "accelerates" at -g
        else:
            xp, qp = x[par], q[par]
            wp, vp, alp, ap = w[par], v[par], alpha[par], a[par]
        r = rot.quat_rotate(qp, jp[i])
        xi = xp + r
        qi = rot.quat_mul(qp, jq[i])
        # velocity/acceleration of the attachment point on the parent body
        vi = vp + jnp.cross(wp, r)
        ai = ap + jnp.cross(alp, r) + jnp.cross(wp, jnp.cross(wp, r))
        if int(model.jnt_type[i]) == HINGE:
            half = 0.5 * qpos[i]
            qz = jnp.stack([jnp.cos(half), jnp.zeros_like(half), jnp.zeros_like(half), jnp.sin(half)])
            qi = rot.quat_mul(qi, qz)
            ax = rot.quat_rotate(qi, jnp.array([0.0, 0, 1.0], dtype=dt))
            wi = wp + ax * qvel[i]
            ali = alp + jnp.cross(wp, ax * qvel[i])
        else:  # SLIDE along local z
            ax = rot.quat_rotate(qi, jnp.array([0.0, 0, 1.0], dtype=dt))
            xi = xi + ax * qpos[i]
            wi = wp
            ali = alp
            # the joint origin rides the slide: r_eff = r + a qpos, and the
            # axis itself rotates with the parent
            vi = vp + jnp.cross(wp, r + ax * qpos[i]) + ax * qvel[i]
            ai = (
                ap
                + jnp.cross(alp, r + ax * qpos[i])
                + jnp.cross(wp, jnp.cross(wp, r + ax * qpos[i]))
                + 2.0 * jnp.cross(wp, ax * qvel[i])
            )
        x.append(xi)
        q.append(qi)
        axis.append(ax)
        w.append(wi)
        v.append(vi)
        alpha.append(ali)
        a.append(ai)

    # ---- body-frame inertial loads at each COM ----
    m = jnp.asarray(model.body_mass, dtype=dt)
    I_diag = jnp.asarray(model.body_inertia, dtype=dt)
    com_l = jnp.asarray(model.body_com, dtype=dt)
    f_net, n_net = [], []  # force at COM, moment about COM
    for i in range(model.nq):
        c = rot.quat_rotate(q[i], com_l[i])  # world COM offset from joint origin
        a_com = a[i] + jnp.cross(alpha[i], c) + jnp.cross(w[i], jnp.cross(w[i], c))
        R = rot.quat_to_mat(q[i])
        Iw = R @ (I_diag[i][:, None] * R.T)
        f_net.append(m[i] * a_com)
        n_net.append(Iw @ alpha[i] + jnp.cross(w[i], Iw @ w[i]))

    # ---- backward pass: accumulate wrenches to parents ----
    F = [None] * model.nq  # total force transmitted through joint i
    N = [None] * model.nq  # total moment about joint i's origin
    tau = [None] * model.nq
    for i in range(model.nq - 1, -1, -1):
        c = rot.quat_rotate(q[i], com_l[i])
        Fi = f_net[i]
        Ni = n_net[i] + jnp.cross(c, f_net[i])
        for ch in range(i + 1, model.nq):
            if int(model.parent[ch]) == i:
                Fi = Fi + F[ch]
                Ni = Ni + N[ch] + jnp.cross(x[ch] - x[i], F[ch])
        F[i] = Fi
        N[i] = Ni
        if int(model.jnt_type[i]) == HINGE:
            tau[i] = jnp.dot(axis[i], Ni)
        else:
            tau[i] = jnp.dot(axis[i], Fi)
    return jnp.stack(x), jnp.stack(q), jnp.stack(axis), jnp.stack(tau)


def mass_matrix_from_frames(
    model: RobotModel, xpos: jax.Array, xquat: jax.Array, axis_w: jax.Array
) -> jax.Array:
    """Joint-space inertia M(q) from precomputed world frames (no FK)."""
    _, jv, jw = body_jacobians(model, xpos, xquat, axis_w)
    m = jnp.asarray(model.body_mass, dtype=xpos.dtype)
    I_diag = jnp.asarray(model.body_inertia, dtype=xpos.dtype)
    R = rot.quat_to_mat(xquat)
    Iw = jnp.einsum("iab,ib,icb->iac", R, I_diag, R)
    M = jnp.einsum("iaj,i,iak->jk", jv, m, jv) + jnp.einsum(
        "iaj,iab,ibk->jk", jw, Iw, jw
    )
    return M + jnp.diag(jnp.asarray(model.armature, dtype=xpos.dtype))
