"""Static robot model specification.

JAX replacement for the reference's MJCF-compile step
(/root/reference/gym_kmanip/env_sim.py:208: mujoco.Physics.from_xml_path).
Instead of compiling XML into an opaque C struct at runtime, a robot is a
plain frozen dataclass of numpy arrays -- a *static pytree* that jitted
functions close over, so XLA bakes the kinematic tree into the executable.

Conventions:
  * quaternions are wxyz (MuJoCo convention)
  * every joint sits at the origin of its body frame with axis +z, which is
    true for every joint in the reference MJCFs (arm_r_body.xml,
    arm_l_body.xml, torso_body.xml: all joints have pos="0 0 0" axis="0 0 1")
  * `jnt_pos`/`jnt_quat` give the *composed* transform from the parent
    joint's frame (or the world for roots) to this joint's frame, folding in
    any intermediate jointless bodies (e.g. robot_root/arm_r offsets in
    _env_solo_arm.xml:4-7).

The reference ships no inertial data at all -- its body inertias would be
derived from STL meshes that are .gitignored (see SURVEY.md §2.2) -- so this
framework assigns engineering estimates per actuator class (X8/X6/X4/slider).
Only the cube's inertial properties are specified in the reference
(scene.xml:16) and are reproduced exactly in constants.py.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from numpy.typing import NDArray

from gym_kmanip_tpu.utils import rotations as rot

HINGE = 0
SLIDE = 1

# engineering mass estimates (kg) per actuator class; the reference has no
# in-repo inertial ground truth (meshes are .gitignored)
_MASS_BY_CLASS = {"x8": 0.8, "x6": 0.5, "x4": 0.3, "slider": 0.06, "head": 0.3}
_ARMATURE_BY_CLASS = {"x8": 0.05, "x6": 0.02, "x4": 0.01, "slider": 0.005, "head": 0.01}
_GYRATION_RADIUS = 0.06  # m, for diagonal inertia estimate I = m r^2


@dataclass(frozen=True)
class SiteSpec:
    name: str
    parent: int  # joint index the site body hangs off
    pos: NDArray  # (3,) offset in parent joint frame
    quat: NDArray  # (4,) wxyz


@dataclass(frozen=True)
class CameraSpec:
    name: str
    parent: int  # joint index, or -1 for world-fixed
    pos: NDArray  # (3,) in parent frame
    fovy: float
    target_site: Optional[str]  # site to track (MuJoCo mode="targetbody")
    target_world: Optional[NDArray]  # world point to track if no site


@dataclass(frozen=True)
class FingertipSpec:
    """Collision sphere standing in for the gripper finger mesh geometry."""

    parent: int  # joint index (a gripper slider)
    pos: NDArray  # (3,) in parent joint frame
    radius: float
    side: str  # "r" or "l"


@dataclass(frozen=True)
class MeshGeomSpec:
    """Triangle-mesh visual geom (MJCF <geom type="mesh">).

    Closes the reference's mesh-render path (physics.render draws STL
    geoms, /root/reference/gym_kmanip/env_sim.py:141-145; the STLs
    themselves are .gitignored upstream, so the built-in robots stay
    capsule-approximated — this spec serves robots IMPORTED with their
    meshes present). Triangles are pre-transformed into the parent
    JOINT frame at load (geom pos/quat + body chain folded in) and
    subsampled to a render budget (models/mjcf.MAX_MESH_TRIS)."""

    name: str
    parent: int  # joint index the geom's body hangs off (-1 = world)
    tris: NDArray  # (T, 3, 3) float32, parent-joint frame


@dataclass(frozen=True)
class RobotModel:
    """Static articulated-robot description (numpy; closed over by jit)."""

    name: str
    nq: int  # robot joints (excludes the free cube)
    nu: int  # actuators
    joint_names: Tuple[str, ...]
    parent: NDArray  # (nq,) int32, -1 for roots
    jnt_pos: NDArray  # (nq,3) parent->joint translation
    jnt_quat: NDArray  # (nq,4) parent->joint rotation
    jnt_type: NDArray  # (nq,) HINGE|SLIDE
    jnt_range: NDArray  # (nq,2)
    jnt_frictionloss: NDArray  # (nq,)
    armature: NDArray  # (nq,)
    # actuators (position servos; actuator i drives joint i for all three
    # robots -- verified identity mapping, see arm_r.xml:44-55, torso.xml:113-135)
    actuator_kp: NDArray  # (nu,)
    actuator_kv: NDArray  # (nu,)
    ctrl_range: NDArray  # (nu,2)
    force_range: NDArray  # (nu,2)
    # per-joint body inertial estimates (joint frame)
    body_mass: NDArray  # (nq,)
    body_com: NDArray  # (nq,3)
    body_inertia: NDArray  # (nq,3) diagonal
    # attached frames
    sites: Tuple[SiteSpec, ...]
    cameras: Tuple[CameraSpec, ...]
    fingertips: Tuple[FingertipSpec, ...]
    # topology helpers
    ancestors: NDArray  # (nq,nq) bool: ancestors[i,j] == joint j moves joint i
    home_qpos: NDArray  # (nq,)
    mocap_pos0: NDArray  # (n_mocap,3)
    mocap_quat0: NDArray  # (n_mocap,4)
    # triangle-mesh visual geoms (empty for the built-in mesh-free robots)
    meshes: Tuple["MeshGeomSpec", ...] = ()

    def site(self, name: str) -> SiteSpec:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(name)

    def site_index(self, name: str) -> int:
        for i, s in enumerate(self.sites):
            if s.name == name:
                return i
        raise KeyError(name)

    def camera(self, name: str) -> CameraSpec:
        for c in self.cameras:
            if c.name == name:
                return c
        raise KeyError(name)


def _compose(frames: List[Tuple[NDArray, NDArray]]) -> Tuple[NDArray, NDArray]:
    """Compose a chain of (pos, quat) frames into one transform."""
    import jax.numpy as jnp

    pos = np.zeros(3)
    quat = np.array([1.0, 0.0, 0.0, 0.0])
    for p, q in frames:
        p = np.asarray(p, dtype=np.float64)
        q = np.asarray(q, dtype=np.float64)
        q = q / np.linalg.norm(q)
        pos = pos + np.asarray(rot.quat_rotate(jnp.array(quat), jnp.array(p)))
        quat = np.asarray(rot.quat_mul(jnp.array(quat), jnp.array(q)))
    return pos, quat / np.linalg.norm(quat)


def quat_from_euler_xyz_np(e) -> NDArray:
    """numpy helper: MJCF <body euler> (extrinsic xyz) -> wxyz quat."""
    import jax.numpy as jnp

    return np.asarray(rot.euler_xyz_to_quat(jnp.asarray(np.asarray(e, dtype=np.float64))))


def _mass_class(name: str) -> str:
    if "slider" in name:
        return "slider"
    if name.startswith("joint_head"):
        return "head"
    for c in ("x8", "x6", "x4"):
        if f"_{c}_" in name:
            return c
    return "x4"


def build_model(
    name: str,
    joints: List[dict],
    sites: List[dict],
    cameras: List[dict],
    fingertips: List[dict],
    actuators: List[dict],
    home_qpos: NDArray,
    mocap_pos0: NDArray,
    mocap_quat0: NDArray,
    meshes: Tuple = (),
) -> RobotModel:
    """Assemble a RobotModel from per-joint dict records.

    Each joint record: {name, parent, frames: [(pos, quat), ...], type,
    range, frictionloss?}. `frames` is the chain of body transforms from the
    parent joint's body down to (and including) this joint's body.
    """
    nq = len(joints)
    parent = np.array([j["parent"] for j in joints], dtype=np.int32)
    jnt_pos = np.zeros((nq, 3))
    jnt_quat = np.zeros((nq, 4))
    for i, j in enumerate(joints):
        if "pos" in j and "quat" in j:
            # precomposed transform (the MJCF loader composes in float64
            # and single-frame shipped assets must pass through bit-exact)
            p, q = j["pos"], j["quat"]
        else:
            p, q = _compose(j["frames"])
        jnt_pos[i] = p
        jnt_quat[i] = q
    jnt_type = np.array(
        [SLIDE if j.get("type") == "slide" else HINGE for j in joints], dtype=np.int32
    )
    jnt_range = np.array([j["range"] for j in joints])
    jnt_frictionloss = np.array([j.get("frictionloss", 0.0) for j in joints])

    # topology: ancestors[i, j] = True iff joint j is on the path from the
    # root to joint i (inclusive) -- i.e. q_j moves the body of joint i
    ancestors = np.zeros((nq, nq), dtype=bool)
    for i in range(nq):
        k = i
        while k >= 0:
            ancestors[i, k] = True
            k = int(parent[k])

    joint_names = tuple(j["name"] for j in joints)
    cls = [_mass_class(n) for n in joint_names]
    # explicit inertials (e.g. from a shipped MJCF <inertial>) win over the
    # per-actuator-class engineering estimates
    body_mass = np.array(
        [j.get("mass", _MASS_BY_CLASS[c]) for j, c in zip(joints, cls)]
    )
    armature = np.array(
        [j.get("armature", _ARMATURE_BY_CLASS[c]) for j, c in zip(joints, cls)]
    )
    # children hang mostly in -z of each body frame; put the com partway there
    est_com = np.tile(np.array([0.0, 0.0, -0.05]), (nq, 1))
    est_com[jnt_type == SLIDE] = np.array([0.0, 0.0, -0.02])
    body_com = np.array(
        [np.asarray(j.get("com", est_com[i]), dtype=np.float64)
         for i, j in enumerate(joints)]
    )
    body_inertia = np.array(
        [np.asarray(
            j.get("inertia", body_mass[i] * _GYRATION_RADIUS**2 * np.ones(3)),
            dtype=np.float64,
        ) for i, j in enumerate(joints)]
    )

    nu = len(actuators)
    actuator_kp = np.array([a["kp"] for a in actuators])
    actuator_kv = np.array([a.get("kv", 0.0) for a in actuators])
    ctrl_range = np.array([a["ctrlrange"] for a in actuators])
    force_range = np.array(
        [a.get("forcerange", (-np.inf, np.inf)) for a in actuators]
    )

    site_specs = tuple(
        SiteSpec(
            s["name"],
            s["parent"],
            np.asarray(s["pos"], dtype=np.float64),
            np.asarray(s.get("quat", (1.0, 0, 0, 0)), dtype=np.float64),
        )
        for s in sites
    )
    cam_specs = tuple(
        CameraSpec(
            c["name"],
            c.get("parent", -1),
            np.asarray(c["pos"], dtype=np.float64),
            float(c["fovy"]),
            c.get("target_site"),
            np.asarray(c["target_world"], dtype=np.float64)
            if c.get("target_world") is not None
            else None,
        )
        for c in cameras
    )
    tip_specs = tuple(
        FingertipSpec(
            f["parent"],
            np.asarray(f["pos"], dtype=np.float64),
            float(f.get("radius", 0.008)),
            f["side"],
        )
        for f in fingertips
    )

    return RobotModel(
        name=name,
        nq=nq,
        nu=nu,
        joint_names=joint_names,
        parent=parent,
        jnt_pos=jnt_pos,
        jnt_quat=jnt_quat,
        jnt_type=jnt_type,
        jnt_range=jnt_range,
        jnt_frictionloss=jnt_frictionloss,
        armature=armature,
        actuator_kp=actuator_kp,
        actuator_kv=actuator_kv,
        ctrl_range=ctrl_range,
        force_range=force_range,
        body_mass=body_mass,
        body_com=body_com,
        body_inertia=body_inertia,
        sites=site_specs,
        cameras=cam_specs,
        fingertips=tip_specs,
        ancestors=ancestors,
        home_qpos=np.asarray(home_qpos, dtype=np.float64),
        mocap_pos0=np.asarray(mocap_pos0, dtype=np.float64),
        mocap_quat0=np.asarray(mocap_quat0, dtype=np.float64),
        meshes=tuple(meshes),
    )
