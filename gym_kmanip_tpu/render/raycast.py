"""On-device camera rendering: a batched raycaster in pure JAX.

JAX replacement for the reference's native OpenGL offscreen renders
(`physics.render(h, w, camera_id)` at /root/reference/gym_kmanip/env_sim.py:
140-145). The reference scene's visual meshes are .gitignored STLs
(SURVEY.md §2.2), so geometric fidelity there is moot; what matters for the
Vision envs is the camera contract -- same camera names, fovy, (h, w, 3)
uint8 frames (Cam specs, reference __init__.py:143-161) -- and that the
pixels actually reflect the simulated world state.

Scene approximation: floor plane, tabletop box, the free cube (oriented
box), robot links as CAPSULES spanning each child-parent joint segment of
the kinematic tree (radius by actuator class) plus joint spheres at the
frames, fingertip spheres. One ray per pixel, closest-hit over the static
primitive list, Lambertian shading under the scene's three directional
lights (scene.xml:5-7). Fully jit/vmap-able: a (h*w, n_primitives)
intersection matrix that XLA tiles cleanly; rollout batches vmap over
world state for learned-cost MPC with vision (env/vec_env.py batches the
same renderer for on-device RL from pixels).
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.models.spec import CameraSpec, RobotModel
from gym_kmanip_tpu.ops import kinematics as kin
from gym_kmanip_tpu.utils import rotations as rot

_BIG = 1e9

# directional lights (scene.xml:5-7: three directional lights over the table)
_LIGHT_DIRS = np.array(
    [[-0.3, -0.3, -1.0], [0.5, -0.2, -0.8], [0.0, 0.5, -0.9]], dtype=np.float32
)
_LIGHT_DIRS /= np.linalg.norm(_LIGHT_DIRS, axis=1, keepdims=True)
_LIGHT_W = np.array([0.5, 0.3, 0.25], dtype=np.float32)
_AMBIENT = 0.35

_SKY = np.array([0.45, 0.62, 0.82], dtype=np.float32)
_FLOOR_A = np.array([0.45, 0.45, 0.45], dtype=np.float32)
_FLOOR_B = np.array([0.35, 0.35, 0.38], dtype=np.float32)
_TABLE_COLOR = np.array([0.55, 0.42, 0.28], dtype=np.float32)
_CUBE_COLOR = np.array([0.85, 0.18, 0.15], dtype=np.float32)
_LINK_COLOR = np.array([0.55, 0.57, 0.60], dtype=np.float32)
_TIP_COLOR = np.array([0.25, 0.25, 0.28], dtype=np.float32)

_LINK_RADIUS = 0.035
# gripper finger slabs (parent jaw frame -> fingertip): square cross-section
_FINGER_HALF_W = 0.007
# capsule radius per actuator class (visual approximation of the link
# bodies between consecutive joint frames)
_CAPSULE_RADIUS = {"x8": 0.045, "x6": 0.038, "x4": 0.030, "slider": 0.012,
                   "head": 0.035}

_TABLE_CENTER = np.array(
    [k.TABLE_POS[0], k.TABLE_POS[1], (k.TABLE_TOP_Z + 0.5) / 2.0], dtype=np.float32
)
_TABLE_HALF = np.array(
    [k.TABLE_HALF_X, k.TABLE_HALF_Y, (k.TABLE_TOP_Z - 0.5) / 2.0], dtype=np.float32
)


def _ray_spheres(o, d, centers, radii):
    """Batched ray-sphere. o,d: (P,3); centers: (S,3); radii: (S,).
    Returns (t, normal): (P,S), (P,S,3)."""
    oc = o[:, None, :] - centers[None, :, :]  # (P,S,3)
    b = jnp.einsum("psk,pk->ps", oc, d)
    c = jnp.sum(oc * oc, axis=-1) - radii[None, :] ** 2
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = -b - sq
    t = jnp.where((disc > 0) & (t > 1e-4), t, _BIG)
    hitp = o[:, None, :] + t[..., None] * d[:, None, :]
    n = (hitp - centers[None, :, :]) / jnp.maximum(radii[None, :, None], 1e-9)
    return t, n


def _ray_capsules(o, d, pa, pb, radii):
    """Batched ray-capsule (cylinder body + spherical caps).
    o,d: (P,3); pa,pb: (C,3) segment ends; radii: (C,).
    Returns (t, normal): (P,C), (P,C,3)."""
    ba = pb - pa  # (C,3)
    oa = o[:, None, :] - pa[None, :, :]  # (P,C,3)
    baba = jnp.maximum(jnp.sum(ba * ba, axis=-1), 1e-12)  # (C,)
    bard = jnp.einsum("ck,pk->pc", ba, d)  # (P,C)
    baoa = jnp.einsum("ck,pck->pc", ba, oa)
    rdoa = jnp.einsum("pk,pck->pc", d, oa)
    oaoa = jnp.sum(oa * oa, axis=-1)
    a2 = baba[None, :] - bard * bard
    b2 = baba[None, :] * rdoa - baoa * bard
    c2 = baba[None, :] * oaoa - baoa * baoa - radii[None, :] ** 2 * baba[None, :]
    h = b2 * b2 - a2 * c2
    a2s = jnp.where(jnp.abs(a2) < 1e-9, 1e-9, a2)
    t_cyl = (-b2 - jnp.sqrt(jnp.maximum(h, 0.0))) / a2s
    y = baoa + t_cyl * bard  # axial coord * baba
    body_ok = (h > 0) & (t_cyl > 1e-4) & (y > 0) & (y < baba[None, :])
    t_cyl = jnp.where(body_ok, t_cyl, _BIG)
    # spherical caps
    t_a, _ = _ray_spheres(o, d, pa, radii)
    t_b, _ = _ray_spheres(o, d, pb, radii)
    t = jnp.minimum(t_cyl, jnp.minimum(t_a, t_b))
    hitp = o[:, None, :] + t[..., None] * d[:, None, :]
    # normal: from the closest point on the segment axis
    s = jnp.clip(
        jnp.einsum("ck,pck->pc", ba, hitp - pa[None, :, :]) / baba[None, :],
        0.0, 1.0,
    )
    axis_pt = pa[None, :, :] + s[..., None] * ba[None, :, :]
    n = (hitp - axis_pt) / jnp.maximum(radii[None, :, None], 1e-9)
    return t, n


def _ray_box(o, d, center, R, half):
    """Ray-OBB via the slab method in the box frame. o,d: (P,3).
    Returns (t, normal): (P,), (P,3) world-frame."""
    ol = (o - center) @ R  # (P,3) box frame (R columns = box axes in world)
    dl = d @ R
    inv = 1.0 / jnp.where(jnp.abs(dl) < 1e-9, jnp.sign(dl) * 1e-9 + 1e-12, dl)
    t1 = (-half - ol) * inv
    t2 = (half - ol) * inv
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    hit = (t_near < t_far) & (t_far > 1e-4) & (t_near > 1e-4)
    t = jnp.where(hit, t_near, _BIG)
    # normal: the axis of the max tmin
    axis = jnp.argmax(tmin, axis=-1)  # (P,)
    sign = -jnp.sign(jnp.take_along_axis(dl, axis[:, None], axis=-1))[:, 0]
    n_local = jax.nn.one_hot(axis, 3, dtype=o.dtype) * sign[:, None]
    return t, n_local @ R.T


def _ray_triangles(o, d, tris):
    """Batched Moller-Trumbore. o,d: (P,3); tris: (T,3,3) world frame.
    Returns (t (P,T), n (P,T,3)); misses are _BIG."""
    v0 = tris[:, 0]  # (T,3)
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])  # (P,T,3)
    det = jnp.sum(pvec * e1[None], axis=-1)  # (P,T)
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tvec = o[:, None, :] - v0[None]  # (P,T,3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv
    t = jnp.sum(e2[None] * qvec, axis=-1) * inv
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (
        jnp.abs(det) > 1e-12
    )
    t = jnp.where(hit, t, _BIG)
    n = jnp.cross(e1, e2)[None]  # (1,T,3) geometric normal
    n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    # face the camera (double-sided shading)
    n = jnp.where(jnp.sum(n * d[:, None, :], axis=-1, keepdims=True) > 0,
                  -n, n)
    return t, jnp.broadcast_to(n, (d.shape[0],) + n.shape[1:])


def _ray_floor(o, d):
    t = -o[:, 2] / jnp.where(jnp.abs(d[:, 2]) < 1e-9, 1e-9, d[:, 2])
    t = jnp.where((t > 1e-4) & (d[:, 2] < 0), t, _BIG)
    return t


def _shade(n, base_color):
    """Lambertian under the fixed directional lights. n: (...,3)."""
    diff = 0.0
    for i in range(len(_LIGHT_W)):
        ld = jnp.asarray(-_LIGHT_DIRS[i], dtype=n.dtype)
        diff = diff + _LIGHT_W[i] * jnp.maximum(jnp.einsum("...k,k->...", n, ld), 0.0)
    return base_color * jnp.clip(_AMBIENT + diff, 0.0, 1.0)[..., None]


def _look_at(cam_pos, target, dtype):
    fwd = target - cam_pos
    fwd = fwd / jnp.maximum(jnp.linalg.norm(fwd), 1e-9)
    up = jnp.array([0.0, 0.0, 1.0], dtype=dtype)
    right = jnp.cross(fwd, up)
    rn = jnp.linalg.norm(right)
    right = jnp.where(rn > 1e-6, right / jnp.maximum(rn, 1e-9), jnp.array([1.0, 0, 0], dtype=dtype))
    up2 = jnp.cross(right, fwd)
    return right, up2, fwd


def render_camera(
    model: RobotModel,
    cam_name: str,
    qpos: jax.Array,
    cube_pos: jax.Array,
    cube_quat: jax.Array,
    height: int,
    width: int,
) -> jax.Array:
    """Render one camera view -> (h, w, 3) uint8.

    Camera placement mirrors the MJCF specs: world cameras sit at fixed
    positions targeting the table (mode="targetbody" fovy=78,
    _env_solo_arm.xml:9-15); grip cameras ride the gripper body targeting
    the EE site (fovy=20, arm_r_body.xml:68).
    """
    dt = qpos.dtype
    cam = model.camera(cam_name)
    xpos, xquat, _ = kin.fk(model, qpos)

    if cam.parent < 0:
        cam_pos = jnp.asarray(cam.pos, dtype=dt)
    else:
        cam_pos = xpos[cam.parent] + rot.quat_rotate(
            xquat[cam.parent], jnp.asarray(cam.pos, dtype=dt)
        )
    if cam.target_site is not None:
        target, _ = kin.site_pose(model, xpos, xquat, cam.target_site)
    else:
        target = jnp.asarray(cam.target_world, dtype=dt)

    right, up, fwd = _look_at(cam_pos, target, dt)
    half_h = jnp.tan(jnp.asarray(np.deg2rad(cam.fovy) / 2.0, dtype=dt))
    half_w = half_h * (width / height)

    ys = jnp.linspace(half_h, -half_h, height, dtype=dt)
    xs = jnp.linspace(-half_w, half_w, width, dtype=dt)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    d = (
        fwd[None, :]
        + gx.reshape(-1)[:, None] * right[None, :]
        + gy.reshape(-1)[:, None] * up[None, :]
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam_pos, d.shape)
    P = d.shape[0]

    # ---- primitives ----
    tip_specs = model.fingertips
    tip_centers = jnp.stack(
        [
            xpos[t.parent] + rot.quat_rotate(xquat[t.parent], jnp.asarray(t.pos, dtype=dt))
            for t in tip_specs
        ]
    ) if tip_specs else jnp.zeros((0, 3), dtype=dt)
    sph_centers = jnp.concatenate([xpos, tip_centers], axis=0)
    sph_radii = jnp.concatenate(
        [
            jnp.full((model.nq,), _LINK_RADIUS, dtype=dt),
            jnp.asarray([t.radius for t in tip_specs], dtype=dt)
            if tip_specs
            else jnp.zeros((0,), dtype=dt),
        ]
    )
    sph_colors = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.asarray(_LINK_COLOR, dtype=dt), (model.nq, 3)),
            jnp.broadcast_to(jnp.asarray(_TIP_COLOR, dtype=dt), (len(tip_specs), 3)),
        ]
    )

    # link capsules along the kinematic tree (child joint frame -> parent
    # joint frame), radius by actuator class
    from gym_kmanip_tpu.models.spec import _mass_class

    cap_pairs = [
        (int(model.parent[i]), i)
        for i in range(model.nq)
        if int(model.parent[i]) >= 0
    ]
    if cap_pairs:
        pa = xpos[jnp.asarray([p for p, _ in cap_pairs])]
        pb = xpos[jnp.asarray([i for _, i in cap_pairs])]
        cap_radii = jnp.asarray(
            [_CAPSULE_RADIUS[_mass_class(model.joint_names[i])]
             for _, i in cap_pairs],
            dtype=dt,
        )
        t_cap, n_cap = _ray_capsules(o, d, pa, pb, cap_radii)  # (P,C)
    else:
        t_cap = jnp.full((P, 0), _BIG, dtype=dt)
        n_cap = jnp.zeros((P, 0, 3), dtype=dt)

    # gripper fingers as thin oriented boxes spanning parent jaw frame ->
    # fingertip (visual stand-ins for the reference's finger geoms, whose
    # STL meshes are gitignored upstream; spheres alone leave the jaws
    # invisible in pick-from-pixels renders)
    if tip_specs:
        par_idx = jnp.asarray([t.parent for t in tip_specs])
        p_par = xpos[par_idx]  # (F,3)
        w = tip_centers - p_par
        L = jnp.maximum(jnp.linalg.norm(w, axis=-1), 1e-6)  # (F,)
        u = w / L[:, None]
        pick_x = jnp.abs(u[:, :1]) < 0.9
        a = jnp.where(
            pick_x,
            jnp.asarray([1.0, 0.0, 0.0], dtype=dt),
            jnp.asarray([0.0, 1.0, 0.0], dtype=dt),
        )
        xax = jnp.cross(a, u)
        xax = xax / jnp.maximum(
            jnp.linalg.norm(xax, axis=-1, keepdims=True), 1e-9
        )
        yax = jnp.cross(u, xax)
        Rf = jnp.stack([xax, yax, u], axis=-1)  # (F,3,3), columns = axes
        tip_r = jnp.asarray([t.radius for t in tip_specs], dtype=dt)
        # extend the slab by tip_r past the FINGERTIP end only: half-length
        # (L + tip_r)/2 with the center shifted tip_r/2 toward the tip (a
        # symmetric L/2 + tip_r half-length would poke tip_r behind the
        # parent jaw frame too)
        cen = (p_par + tip_centers) / 2.0 + (tip_r[:, None] / 2.0) * u
        half = jnp.stack(
            [
                jnp.full_like(L, _FINGER_HALF_W),
                jnp.full_like(L, _FINGER_HALF_W),
                (L + tip_r) / 2.0,
            ],
            axis=-1,
        )
        t_f, n_f = jax.vmap(lambda c, R, h: _ray_box(o, d, c, R, h))(
            cen, Rf, half
        )
        t_fing = jnp.moveaxis(t_f, 0, 1)  # (P,F)
        n_fing = jnp.moveaxis(n_f, 0, 1)  # (P,F,3)
    else:
        t_fing = jnp.full((P, 0), _BIG, dtype=dt)
        n_fing = jnp.zeros((P, 0, 3), dtype=dt)

    # body-mounted cameras (grip cams ride the wrist body): exclude the
    # mount body's own joint sphere and the link capsule ENDING at it —
    # the visual capsules are fatter than the real meshes the reference's
    # camera sits outside of, so without this the whole frame is the
    # inside of the wrist link. Jaw capsules/tips stay visible.
    if cam.parent >= 0:
        sph_radii = sph_radii.at[cam.parent].set(0.0)
        if cap_pairs:
            cap_mask = np.asarray(
                [i == cam.parent for _, i in cap_pairs], dtype=bool
            )
            if cap_mask.any():
                t_cap = jnp.where(cap_mask[None, :], _BIG, t_cap)

    # triangle-mesh geoms (imported robots with their STLs present;
    # built-in robots are mesh-free and skip this block entirely)
    if model.meshes:
        world_tris = []
        for mg in model.meshes:
            tris = jnp.asarray(mg.tris, dtype=dt)  # (T,3,3) parent frame
            if mg.parent >= 0:
                R = rot.quat_to_mat(xquat[mg.parent])  # (3,3)
                tris = tris @ R.T + xpos[mg.parent][None, None, :]
            world_tris.append(tris.reshape(-1, 3, 3))
        t_mesh, n_mesh = _ray_triangles(o, d, jnp.concatenate(world_tris))
    else:
        t_mesh = jnp.full((P, 0), _BIG, dtype=dt)
        n_mesh = jnp.zeros((P, 0, 3), dtype=dt)

    t_sph, n_sph = _ray_spheres(o, d, sph_centers, sph_radii)  # (P,S)
    t_cube, n_cube = _ray_box(
        o, d, cube_pos, rot.quat_to_mat(cube_quat), jnp.full((3,), k.CUBE_HALF_SIZE, dtype=dt)
    )
    t_table, n_table = _ray_box(
        o, d, jnp.asarray(_TABLE_CENTER, dtype=dt), jnp.eye(3, dtype=dt),
        jnp.asarray(_TABLE_HALF, dtype=dt),
    )
    t_floor = _ray_floor(o, d)

    # closest-hit resolution
    t_all = jnp.concatenate(
        [t_cap, t_fing, t_mesh, t_sph, t_cube[:, None], t_table[:, None],
         t_floor[:, None]],
        axis=1,
    )  # (P, C+F+M+S+3)
    idx = jnp.argmin(t_all, axis=1)
    t_best = jnp.min(t_all, axis=1)
    S = sph_centers.shape[0]

    # shaded colors per primitive family
    c_sph = _shade(n_sph, sph_colors[None, :, :])  # (P,S,3)
    c_cube = _shade(n_cube, jnp.asarray(_CUBE_COLOR, dtype=dt))  # (P,3)
    c_table = _shade(n_table, jnp.asarray(_TABLE_COLOR, dtype=dt))
    hitp = o + t_floor[:, None] * d
    checker = ((jnp.floor(hitp[:, 0] * 2) + jnp.floor(hitp[:, 1] * 2)) % 2).astype(dt)
    c_floor = (
        checker[:, None] * jnp.asarray(_FLOOR_A, dtype=dt)
        + (1 - checker[:, None]) * jnp.asarray(_FLOOR_B, dtype=dt)
    )

    c_cap = _shade(n_cap, jnp.asarray(_LINK_COLOR, dtype=dt)[None, None, :])
    c_fing = _shade(n_fing, jnp.asarray(_TIP_COLOR, dtype=dt)[None, None, :])
    c_mesh = _shade(n_mesh, jnp.asarray(_LINK_COLOR, dtype=dt)[None, None, :])
    c_all = jnp.concatenate(
        [c_cap, c_fing, c_mesh, c_sph, c_cube[:, None, :],
         c_table[:, None, :], c_floor[:, None, :]],
        axis=1,
    )  # (P, C+F+M+S+3, 3)
    color = jnp.take_along_axis(c_all, idx[:, None, None], axis=1)[:, 0, :]
    color = jnp.where(t_best[:, None] >= _BIG, jnp.asarray(_SKY, dtype=dt), color)

    img = jnp.clip(color.reshape(height, width, 3) * 255.0, 0, 255).astype(jnp.uint8)
    return img


def make_render_fn(model: RobotModel, cam_name: str, height: int, width: int):
    """Jitted renderer for one camera, closed over static geometry."""
    return jax.jit(
        partial(render_camera, model, cam_name, height=height, width=width)
    )
