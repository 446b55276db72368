"""Penalty-based contact model: cube-table and fingertip-cube.

JAX replacement for MuJoCo's soft-constraint contact solve (the
reference cube's solref/solimp/condim=4 spec at
/root/reference/gym_kmanip/assets/scene.xml:20 and the contact scan at
env_sim.py:163-178).

Design: the contact *set* is static -- 8 cube corners vs the table plane,
plus every fingertip sphere vs the cube box (no finger-table pairs: the
reference ships no finger collision geoms, so its grippers pass through the
tabletop; see fingertips_cube_table) -- so all
shapes are fixed and the whole model is one fused elementwise block under
jit/vmap. Activation is by smooth max(0, penetration) gating, not by
data-dependent branching, which keeps XLA happy and the model differentiable
for gradient-based MPC.

Normal forces follow MuJoCo's impedance/reference-acceleration semantics
(solref="0.01 1", scene.xml:20) rather than a raw penalty spring:

  aref = kappa * pen - beta * v_n      (kappa = 1/tc^2, beta = 2/tc)
  f_n  = m_eff * max(0, aref - a0_n)   (a0_n: non-contact normal accel)
  f_t  = -mu * f_n * v_t / sqrt(|v_t|^2 + v_slip^2)

so penetration returns to ~0 critically damped (tau = 10 ms), impacts do
not bounce, and gravity/grasp loads are absorbed by the force instead of
showing up as mg/k rest penetration — matching the reference cube's
settling trace to ~3e-5 m (tests/golden). m_eff is the cube mass (split
across active corners for the table contact; the arm side of a fingertip
pair is far heavier through the Jacobian, so the pair inertia is
cube-dominated).
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.utils import rotations as rot

# 8 cube corner offsets in the cube frame, scaled by half-size. numpy
# (host) on purpose: a numpy constant is baked into the HLO as a literal,
# while a module-level device array would become a hidden input of every
# program that closes over it (tests/test_no_device_closures.py).
_CORNERS = np.array(
    [
        [sx, sy, sz]
        for sx in (-1.0, 1.0)
        for sy in (-1.0, 1.0)
        for sz in (-1.0, 1.0)
    ]
)


class ContactOut(NamedTuple):
    force_cube: jax.Array  # (3,) net world force on the cube
    torque_cube: jax.Array  # (3,) net world torque about the cube COM
    tip_forces: jax.Array  # (n_tips, 3) world force on each fingertip
    touch_tip: jax.Array  # (n_tips,) bool fingertip-cube contact
    touch_table: jax.Array  # () bool cube-table contact


def _normal_force(
    pen: jax.Array, vn: jax.Array, a0: jax.Array, m_eff
) -> jax.Array:
    """MuJoCo-impedance normal force, active only in penetration.

    pen > 0 penetrating, vn > 0 separating, a0 = normal component of the
    relative acceleration the pair would have WITHOUT this force (so the
    force both tracks aref and cancels a0, like the constraint solve)."""
    aref = k.CONTACT_KAPPA * pen - k.CONTACT_BETA * vn
    return jnp.where(pen > 0, m_eff * jnp.maximum(aref - a0, 0.0), 0.0)


def _friction(fn: jax.Array, vt: jax.Array) -> jax.Array:
    """Smooth Coulomb friction force (world), vt: (..., 3)."""
    speed = jnp.sqrt(jnp.sum(vt * vt, axis=-1, keepdims=True) + k.CONTACT_SLIP_VEL**2)
    return -k.CONTACT_FRICTION_MU * fn[..., None] * vt / speed


def _over_table(p: jax.Array) -> jax.Array:
    """Bool: world point is horizontally above the tabletop box."""
    return (jnp.abs(p[..., 0] - k.TABLE_POS[0]) < k.TABLE_HALF_X) & (
        jnp.abs(p[..., 1] - k.TABLE_POS[1]) < k.TABLE_HALF_Y
    )


def cube_table(
    cube_pos: jax.Array,
    cube_quat: jax.Array,
    cube_linvel: jax.Array,
    cube_angvel: jax.Array,
    ext_force: jax.Array | None = None,
    ext_torque: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Corner-vs-plane contact of the cube with the tabletop (and the floor
    at z=0 when the cube is off the table).

    ext_force/ext_torque: net NON-table force/torque on the cube (gravity +
    fingertip contacts) — the a0 the impedance force must cancel, one
    Gauss-Seidel pass like MuJoCo's solver ordering. Defaults to gravity
    only. Returns (force, torque, touching) on/about the cube COM.
    """
    dtype = cube_pos.dtype
    if ext_force is None:
        ext_force = k.CUBE_MASS * jnp.asarray(k.GRAVITY, dtype=dtype)
    if ext_torque is None:
        ext_torque = jnp.zeros(3, dtype=dtype)

    R = rot.quat_to_mat(cube_quat)
    corners_w = cube_pos + (_CORNERS.astype(dtype) * k.CUBE_HALF_SIZE) @ R.T
    arm = corners_w - cube_pos  # (8,3)
    v_corner = cube_linvel + jnp.cross(cube_angvel, arm)  # (8,3)

    over = _over_table(corners_w)
    plane_z = jnp.where(over, k.TABLE_TOP_Z, 0.0)
    pen = plane_z - corners_w[:, 2]  # (8,)
    vn = v_corner[:, 2]

    # non-contact z-acceleration of each corner: COM + angular + centripetal
    alpha = ext_torque / k.CUBE_DIAG_INERTIA
    a_corner = (
        ext_force / k.CUBE_MASS
        + jnp.cross(alpha, arm)
        + jnp.cross(cube_angvel, jnp.cross(cube_angvel, arm))
    )
    # share the cube mass across simultaneously active corners (diagonal
    # approximation of the coupled contact solve)
    n_act = jnp.maximum(jnp.sum((pen > 0).astype(dtype)), 1.0)
    fn = _normal_force(pen, vn, a_corner[:, 2], k.CUBE_MASS / n_act)  # (8,)
    vt = v_corner.at[:, 2].set(0.0)
    ft = _friction(fn, vt)  # (8,3)
    f = ft.at[:, 2].add(fn)  # (8,3)

    force = jnp.sum(f, axis=0)
    torque = jnp.sum(jnp.cross(arm, f), axis=0)
    touching = jnp.any((pen > 0) & over)
    return force, torque, touching


def sphere_box(
    center_local: jax.Array, radius: float, half: float
) -> Tuple[jax.Array, jax.Array]:
    """Sphere vs origin-centered box in the box frame.

    Returns (pen, normal_local): penetration depth (>0 touching) and the
    contact normal pointing from the box surface toward the sphere center.
    Handles the center-inside-box case by pushing out along the closest face.
    """
    clamped = jnp.clip(center_local, -half, half)
    delta = center_local - clamped
    # double-where safe norm: delta == 0 whenever the center is inside the
    # box, and norm's NaN derivative there would leak through `where` into
    # iLQR's jacfwd of in-contact states
    sq = jnp.sum(delta * delta)
    outside = sq > 1e-18
    dist = jnp.sqrt(jnp.where(outside, sq, 1.0))

    # outside: usual closest-point normal
    n_out = delta / dist
    pen_out = radius - dist

    # inside: exit through the face with the smallest remaining distance
    face_dist = half - jnp.abs(center_local)  # (3,) >= 0 when inside
    axis = jnp.argmin(face_dist)
    sign = jnp.sign(center_local[axis] + 1e-12)
    n_in = jnp.zeros(3, dtype=center_local.dtype).at[axis].set(sign)
    pen_in = radius + face_dist[axis]

    pen = jnp.where(outside, pen_out, pen_in)
    normal = jnp.where(outside, n_out, n_in)
    return pen, normal


def fingertips_cube_table(
    tip_pos: jax.Array,  # (T,3) world fingertip sphere centers
    tip_vel: jax.Array,  # (T,3) world velocities
    tip_radius: jax.Array,  # (T,)
    cube_pos: jax.Array,
    cube_quat: jax.Array,
    cube_linvel: jax.Array,
    cube_angvel: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Fingertip spheres vs the cube box.

    Returns (tip_forces (T,3), cube_force (3,), cube_torque (3,),
    touch (T,) bool tip-cube contact).
    """
    R = rot.quat_to_mat(cube_quat)

    def one_tip(p, v, r):
        local = R.T @ (p - cube_pos)
        pen, n_local = sphere_box(local, r, k.CUBE_HALF_SIZE)
        n = R @ n_local  # world, cube -> tip
        cpoint = p - n * (r - jnp.maximum(pen, 0.0) * 0.5)
        arm = cpoint - cube_pos
        v_cube_pt = cube_linvel + jnp.cross(cube_angvel, arm)
        v_rel = v - v_cube_pt
        vn = jnp.dot(v_rel, n)
        # a0: relative normal acceleration without this force. The tip is
        # servo-held (a_tip ~ 0); the cube free-falls, so a0 = -g.n. The
        # pair's effective inertia is cube-dominated (arm reflected inertia
        # through the Jacobian >> 0.05 kg), m_eff = cube mass.
        a0 = -jnp.dot(jnp.asarray(k.GRAVITY, dtype=p.dtype), n)
        fn = _normal_force(pen, vn, a0, k.CUBE_MASS)
        vt = v_rel - vn * n
        f_tip = fn * n + _friction(fn, vt)
        # NO tip-vs-table force: the reference ships no finger collision
        # geoms (meshes are .gitignored upstream; the reward's
        # left/right_gripper_finger names match nothing, SURVEY.md §2.2), so
        # its grippers pass through the tabletop freely — the torso home
        # pose actually hangs the hands BELOW table-top height. We add
        # fingertip spheres only against the CUBE (the documented fix that
        # makes grasping and the touch reward real); a tip-table force here
        # would inject ~100 N torques the reference dynamics never see.
        return f_tip, -fn * n - _friction(fn, vt), arm, pen > 0

    f_tips, f_cubes, arms, touch = jax.vmap(one_tip)(tip_pos, tip_vel, tip_radius)
    cube_force = jnp.sum(f_cubes, axis=0)
    cube_torque = jnp.sum(jnp.cross(arms, f_cubes), axis=0)
    return f_tips, cube_force, cube_torque, touch


def contact_forces(
    tip_pos: jax.Array,
    tip_vel: jax.Array,
    tip_radius: jax.Array,
    cube_pos: jax.Array,
    cube_quat: jax.Array,
    cube_linvel: jax.Array,
    cube_angvel: jax.Array,
) -> ContactOut:
    """All contact forces for one world state.

    Fingertip pairs are evaluated FIRST; their force on the cube feeds the
    table contact's a0 (one Gauss-Seidel pass), so a grasp squeezing the
    cube into the table is resisted by the table force like MuJoCo's
    coupled solve."""
    f_tips, f_cube, t_cube, touch = fingertips_cube_table(
        tip_pos, tip_vel, tip_radius, cube_pos, cube_quat, cube_linvel, cube_angvel
    )
    g_force = k.CUBE_MASS * jnp.asarray(k.GRAVITY, dtype=cube_pos.dtype)
    f_table, t_table, touch_table = cube_table(
        cube_pos, cube_quat, cube_linvel, cube_angvel,
        ext_force=g_force + f_cube, ext_torque=t_cube,
    )
    return ContactOut(
        force_cube=f_table + f_cube,
        torque_cube=t_table + t_cube,
        tip_forces=f_tips,
        touch_tip=touch,
        touch_table=touch_table,
    )
