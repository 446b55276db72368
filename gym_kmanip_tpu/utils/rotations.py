"""Pure-JAX quaternion / rotation library (wxyz convention, like MuJoCo).

JAX replacement for the reference's mix of scipy.spatial.transform and
MuJoCo C quaternion utilities (mju_mat2Quat / mju_subQuat / mjd_subQuat used
at /root/reference/gym_kmanip/ik_mujoco.py:43-86 and scipy Rotation used at
/root/reference/gym_kmanip/env_sim.py:67-89).

All functions are elementwise on the last axis and broadcast over any number
of leading batch dimensions, so they compose with vmap/jit/scan for free.
Quaternions are (w, x, y, z).
"""

import jax
import jax.numpy as jnp

_EPS = 1e-12


def normalize(q: jax.Array) -> jax.Array:
    """Normalize quaternion(s) to unit length."""
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(_EPS)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a ⊗ b (wxyz)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_inv(q: jax.Array) -> jax.Array:
    """Inverse for (approximately) unit quaternions."""
    return quat_conj(q)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_rotate_inv(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Unit quaternion -> 3x3 rotation matrix (body->world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: jax.Array) -> jax.Array:
    """3x3 rotation matrix -> unit quaternion (wxyz).

    Branch-free (jnp.where-select over the four Shepperd cases) so it is safe
    under jit/vmap; equivalent to MuJoCo's mju_mat2Quat.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate quaternions, one per dominant component
    qw = jnp.stack(
        [1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1
    )
    qx = jnp.stack(
        [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1
    )
    qy = jnp.stack(
        [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1
    )
    qz = jnp.stack(
        [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1
    )
    # pick the case with the largest pivot for numerical stability
    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        axis=-1,
    )
    case = jnp.argmax(pivots, axis=-1)[..., None]
    q = jnp.where(
        case == 0, qw, jnp.where(case == 1, qx, jnp.where(case == 2, qy, qz))
    )
    q = normalize(q)
    # canonical sign: w >= 0 (MuJoCo convention)
    return jnp.where(q[..., :1] < 0, -q, q)


def quat_from_axis_angle(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Unit quaternion for rotation of `angle` radians about unit `axis`."""
    half = 0.5 * angle[..., None]
    return jnp.concatenate(
        [jnp.cos(half), jnp.sin(half) * axis], axis=-1
    )


def quat_log(q: jax.Array) -> jax.Array:
    """Log map: unit quaternion -> rotation vector (angle * axis).

    Differentiable at the identity: the vector norm is computed with the
    double-where trick (norm's derivative at 0 is NaN and `where` alone does
    not stop NaN propagation through jacfwd/jvp).
    """
    w = q[..., 0]
    v = q[..., 1:]
    sq = jnp.sum(v * v, axis=-1)
    small = sq < 1e-14
    vn = jnp.sqrt(jnp.where(small, 1.0, sq))
    angle = 2.0 * jnp.arctan2(vn, w)
    # wrap to (-pi, pi] so the result is the minimal rotation
    angle = jnp.where(angle > jnp.pi, angle - 2 * jnp.pi, angle)
    # near identity: angle/vn -> 2/w smoothly (Taylor of 2*atan2(x,w)/x)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / vn)
    return v * scale[..., None]


def quat_sub(qa: jax.Array, qb: jax.Array) -> jax.Array:
    """3D velocity v with qb ⊗ exp(v/2) = qa, in qb's local frame.

    Equivalent to MuJoCo's mju_subQuat (used by the reference IK residual,
    ik_mujoco.py:46).
    """
    return quat_log(quat_mul(quat_conj(qb), qa))


def quat_integrate(q: jax.Array, omega: jax.Array, dt) -> jax.Array:
    """Integrate unit quaternion by world-frame angular velocity omega*dt.

    Differentiable at omega = 0 (double-where safe norm + Taylor branch);
    plain norm here poisons jacfwd of any dynamics step from a resting
    state, which is exactly iLQR's linearization point.
    """
    rot = omega * dt
    sq = jnp.sum(rot * rot, axis=-1, keepdims=True)
    small = sq < 1e-14
    angle = jnp.sqrt(jnp.where(small, 1.0, sq))
    half = 0.5 * angle
    # sin(a/2)/a and cos(a/2), with Taylor expansions near zero
    scale = jnp.where(small, 0.5 - sq / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - sq / 8.0, jnp.cos(half))
    dq = jnp.concatenate([w, scale * rot], axis=-1)
    return normalize(quat_mul(dq, q))


def euler_xyz_to_quat(euler: jax.Array) -> jax.Array:
    """Extrinsic x-y-z Euler angles -> quaternion.

    Matches scipy R.from_euler("xyz", e): R = Rz(e2) @ Ry(e1) @ Rx(e0)
    (used to decode ee_orn actions, reference env_sim.py:69).
    """
    ex, ey, ez = euler[..., 0], euler[..., 1], euler[..., 2]
    zeros = jnp.zeros_like(ex)
    qx = quat_from_axis_angle(
        jnp.stack([jnp.ones_like(ex), zeros, zeros], axis=-1), ex
    )
    qy = quat_from_axis_angle(
        jnp.stack([zeros, jnp.ones_like(ey), zeros], axis=-1), ey
    )
    qz = quat_from_axis_angle(
        jnp.stack([zeros, zeros, jnp.ones_like(ez)], axis=-1), ez
    )
    return quat_mul(qz, quat_mul(qy, qx))


def quat_to_euler_xyz(q: jax.Array) -> jax.Array:
    """Quaternion -> extrinsic x-y-z Euler angles (scipy "xyz" convention)."""
    m = quat_to_mat(q)
    ex = jnp.arctan2(m[..., 2, 1], m[..., 2, 2])
    ey = jnp.arcsin(jnp.clip(-m[..., 2, 0], -1.0, 1.0))
    ez = jnp.arctan2(m[..., 1, 0], m[..., 0, 0])
    return jnp.stack([ex, ey, ez], axis=-1)


def euler_seq_to_quat(euler: jax.Array) -> jax.Array:
    """MJCF <body euler="..."> convention: intrinsic? MuJoCo uses extrinsic
    x-y-z by default (eulerseq="xyz"), same as euler_xyz_to_quat."""
    return euler_xyz_to_quat(euler)
