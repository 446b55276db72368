"""Framework-wide constants.

Mirrors the configuration surface of the reference suite
(/root/reference/gym_kmanip/__init__.py:14-222): every hyperparameter a user of
the reference relies on exists here under the same name with the same default.

The values are physical / behavioral facts of the K-Scale "Stompy" robots and
the cube-pick task; the code around them is a fresh JAX design.
"""

from collections import OrderedDict as ODict
from dataclasses import dataclass, field
import os
from typing import List, OrderedDict, Tuple

import numpy as np
from numpy.typing import NDArray

ASSETS_DIR: str = os.path.join(os.path.dirname(__file__), "assets")
DATA_DIR: str = os.path.join(os.path.dirname(__file__), "data")

DATE_FORMAT: str = "%mm%dd%Yy_%Hh%Mm"

# Robot model identifiers (the reference selects robots via MJCF filenames,
# gym_kmanip/__init__.py:18-20; we key a registry of static model pytrees).
SOLO_ARM_MJCF: str = "_env_solo_arm.xml"
DUAL_ARM_MJCF: str = "_env_dual_arm.xml"
TORSO_MJCF: str = "_env_torso.xml"

SOLO_ARM_URDF: str = "stompy_tiny_solo_arm_glb.urdf"
DUAL_ARM_URDF: str = "stompy_dual_arm_tiny_glb.urdf"
TORSO_URDF: str = "stompy_tiny_glb/robot.urdf"

# Episode / timing (reference gym_kmanip/__init__.py:28-34)
MAX_EPISODE_STEPS: int = 64
FPS: int = 30
CONTROL_TIMESTEP: float = 0.02  # seconds per control step
PHYSICS_TIMESTEP: float = 0.002  # MuJoCo default <option timestep>; 10 substeps
N_SUBSTEPS: int = int(round(CONTROL_TIMESTEP / PHYSICS_TIMESTEP))
MAX_Q_VEL: float = np.pi  # rad/s
GRAVITY: Tuple[float, float, float] = (0.0, 0.0, -9.81)

# exponential filtering for control signal (alpha=1 => passthrough; parity
# with reference CTRL_ALPHA, gym_kmanip/__init__.py:34)
CTRL_ALPHA: float = 1.0

# IK hyperparameters (reference gym_kmanip/__init__.py:36-41)
IK_RES_RAD: float = 0.02
IK_RES_REG_PREV: float = 6e-3
IK_RES_REG_HOME: float = 2e-6
IK_JAC_RAD: float = 0.02
IK_JAC_REG: float = 9e-3
# fixed iteration budget for the batched Levenberg-Marquardt IK solve; the
# reference uses scipy's adaptive TRF (ik_mujoco.py:129) which cannot be
# jitted -- a fixed-budget LM with adaptive damping matches its solutions to
# well below actuator resolution while staying XLA-compilable.
IK_MAX_ITERS: int = 12

# Datasets (reference gym_kmanip/__init__.py:43-47)
H5PY_CHUNK_SIZE_BYTES: int = 1024**2 * 2
HF_LEROBOT_VERSION: str = "v1.4"
HF_LEROBOT_BATCH_SIZE: int = 32
HF_LEROBOT_NUM_WORKERS: int = 8

# Gym spaces dtypes (reference gym_kmanip/__init__.py:50-51)
OBS_DTYPE: np.dtype = np.float64
ACT_DTYPE: np.dtype = np.float32

# Home poses (reference gym_kmanip/__init__.py:53-122). Ordered dicts keyed by
# the MJCF joint names, in MuJoCo depth-first qpos order.
Q_SOLO_ARM_HOME_DICT: OrderedDict[str, float] = ODict()
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 0.75
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 1.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 2.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_3_dof_x4"] = -2.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_1_dof_x4"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_2_dof_x4"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_3"] = 0.005
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_1"] = 0.005
Q_SOLO_ARM_HOME: NDArray = np.array(
    list(Q_SOLO_ARM_HOME_DICT.values()), dtype=ACT_DTYPE
)
Q_SOLO_ARM_KEYS: List[str] = list(Q_SOLO_ARM_HOME_DICT.keys())

Q_DUAL_ARM_HOME_DICT: OrderedDict[str, float] = ODict()
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 0.75
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 1.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 2.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_3_dof_x4"] = -2.7
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_1_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_2_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_3"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_1"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x8_1_dof_x8"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x8_2_dof_x8"] = -0.75
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x6_1_dof_x6"] = -1.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x6_2_dof_x6"] = -1.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x4_1_dof_x4"] = 2.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_3_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_1_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_2_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_slider_3"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_slider_1"] = 0.005
Q_DUAL_ARM_HOME: NDArray = np.array(
    list(Q_DUAL_ARM_HOME_DICT.values()), dtype=ACT_DTYPE
)
Q_DUAL_ARM_KEYS: List[str] = list(Q_DUAL_ARM_HOME_DICT.keys())

Q_TORSO_HOME_DICT: OrderedDict[str, float] = ODict()
Q_TORSO_HOME_DICT["joint_head_1_x4_1_dof_x4"] = -1.0
Q_TORSO_HOME_DICT["joint_head_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 1.7
Q_TORSO_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 1.6
Q_TORSO_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 0.34
Q_TORSO_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.6
Q_TORSO_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 1.4
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_x4_1_dof_x4"] = -0.26
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_slider_1"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_slider_2"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_x8_1_dof_x8"] = -1.7
Q_TORSO_HOME_DICT["joint_left_arm_2_x8_2_dof_x8"] = -1.6
Q_TORSO_HOME_DICT["joint_left_arm_2_x6_1_dof_x6"] = -0.34
Q_TORSO_HOME_DICT["joint_left_arm_2_x6_2_dof_x6"] = -1.6
Q_TORSO_HOME_DICT["joint_left_arm_2_x4_1_dof_x4"] = -1.4
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_x4_1_dof_x4"] = -1.7
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_slider_1"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_slider_2"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME: NDArray = np.array(list(Q_TORSO_HOME_DICT.values()), dtype=ACT_DTYPE)
Q_TORSO_KEYS: List[str] = list(Q_TORSO_HOME_DICT.keys())

# Per-environment q / ctrl index masks (reference gym_kmanip/__init__.py:124-136)
Q_ID_R_MASK_SOLO: NDArray = np.array([0, 1, 2, 3, 4, 5, 6])
CTRL_ID_R_GRIP_SOLO: NDArray = np.array([8, 9])

Q_ID_R_MASK_DUAL: NDArray = np.array([0, 1, 2, 3, 4, 5, 6])
Q_ID_L_MASK_DUAL: NDArray = np.array([10, 11, 12, 13, 14, 15, 16])
CTRL_ID_R_GRIP_DUAL: NDArray = np.array([8, 9])
CTRL_ID_L_GRIP_DUAL: NDArray = np.array([18, 19])

Q_ID_R_MASK_TORSO: NDArray = np.array([2, 3, 4, 5, 6, 7])
Q_ID_L_MASK_TORSO: NDArray = np.array([11, 12, 13, 14, 15, 16])
CTRL_ID_R_GRIP_TORSO: NDArray = np.array([8, 9])
CTRL_ID_L_GRIP_TORSO: NDArray = np.array([17, 18])

# mocap objects are set by hand poses (reference gym_kmanip/__init__.py:139-140)
MOCAP_ID_R: int = 0
MOCAP_ID_L: int = 1


@dataclass
class Cam:
    """Camera spec (reference gym_kmanip/__init__.py:143-161)."""

    w: int  # image width
    h: int  # image height
    c: int  # image channels
    fl: int  # focal length
    pp: Tuple[int, int]  # principal point
    name: str
    log_name: str
    low: int = 0
    high: int = 255
    dtype = np.uint8
    # extra fields used by the real-robot backend (the reference accesses
    # cam.device_id / cam.fps without defining them, env_real.py:38-42 -- we
    # fix that contract here)
    device_id: int = 0
    fps: int = 30


CAMERAS: OrderedDict[str, Cam] = ODict()
CAMERAS["head"] = Cam(640, 480, 3, 448, (320, 240), "head", "camera/head")
CAMERAS["top"] = Cam(640, 480, 3, 448, (320, 240), "top", "camera/top")
CAMERAS["grip_r"] = Cam(60, 40, 3, 45, (30, 20), "grip_r", "camera/grip_r")
CAMERAS["grip_l"] = Cam(60, 40, 3, 45, (30, 20), "grip_l", "camera/grip_l")

# cube spawn randomization bounds (reference gym_kmanip/__init__.py:164-170)
CUBE_SPAWN_RANGE: NDArray = np.array(
    [
        [0.1, 0.3],  # X
        [0.5, 0.7],  # Y
        [0.6, 0.7],  # Z
    ]
)

# EE deltas (reference gym_kmanip/__init__.py:174-189)
EE_POS_DELTA: NDArray = np.array([0.01, 0.01, 0.01])
EE_ORN_DELTA: NDArray = np.array([0.1, 0.1, 0.1])
EE_DEFAULT_ORN: NDArray = np.array([1, 0, 0, 0])

EPSILON: float = 1e-6

Q_POS_DELTA: float = 0.1  # radians

# gripper slider range (reference gym_kmanip/__init__.py:199-201)
EE_S_MIN: float = -0.029  # closed
EE_S_MAX: float = 0.005  # open
EE_S_DELTA: float = 0.0001

# reward shaping (reference gym_kmanip/__init__.py:204-208)
REWARD_SUCCESS_THRESHOLD: float = 2.0
REWARD_VEL_PENALTY: float = 0.01
REWARD_GRIP_DIST: float = 0.01
REWARD_TOUCH_CUBE: float = 1.0
REWARD_LIFT_CUBE: float = 1.0

# quaternion convention converters (reference gym_kmanip/__init__.py:212-213)
XYZW_2_WXYZ: NDArray = np.array([3, 0, 1, 2])
WXYZ_2_XYZW: NDArray = np.array([1, 2, 3, 0])

# MuJoCo <-> Vuer frame conversions for VR teleop (reference
# gym_kmanip/__init__.py:214-241). Host-side numpy-only utilities (the
# reference routes these through scipy Rotation; re-implemented with plain
# rotation matrices so the core package has no scipy runtime dependency —
# outputs verified identical to the scipy path, tests/test_teleop.py); the
# device-side math lives in utils/rotations.py.


def _np_quat_xyzw_to_mat(q: NDArray) -> NDArray:
    x, y, z, w = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _np_mat_to_quat_xyzw(m: NDArray) -> NDArray:
    """Shepperd's method with scipy's exact (non-canonical) sign rule: the
    component picked by argmax([m00, m11, m22, trace]) takes the positive
    square root — byte-parity with Rotation.as_quat() so the reference's
    vuer2mj_orn outputs match including sign."""
    t = float(np.trace(m))
    choice = int(np.argmax([m[0, 0], m[1, 1], m[2, 2], t]))
    if choice == 3:
        w = 0.5 * np.sqrt(1.0 + t)
        s = 0.25 / w
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, w])
    i = choice
    j, kk = (i + 1) % 3, (i + 2) % 3
    xi = 0.5 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[kk, kk], 0.0))
    s = 0.25 / xi
    q = np.zeros(4)
    q[i] = xi
    q[j] = (m[j, i] + m[i, j]) * s
    q[kk] = (m[kk, i] + m[i, kk]) * s
    q[3] = (m[kk, j] - m[j, kk]) * s
    return q


def _np_mat_to_euler_xyz(m: NDArray) -> NDArray:
    """Extrinsic-xyz euler of M = Rz(c) @ Ry(b) @ Rx(a), scipy-compatible."""
    b = float(np.arcsin(np.clip(-m[2, 0], -1.0, 1.0)))
    a = float(np.arctan2(m[2, 1], m[2, 2]))
    c = float(np.arctan2(m[1, 0], m[0, 0]))
    return np.array([a, b, c])


# Rz(pi) @ Rx(pi/2) (reference MJ_TO_VUER_ROT, __init__.py:214-215)
MJ_TO_VUER_MAT: NDArray = np.array(
    [[-1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]
)
VUER_TO_MJ_MAT: NDArray = MJ_TO_VUER_MAT.T


def mj2vuer_pos(pos: NDArray) -> NDArray:
    return MJ_TO_VUER_MAT @ np.asarray(pos, dtype=np.float64)


def mj2vuer_orn(orn: NDArray, offset: NDArray = None) -> NDArray:
    """wxyz quat (+ optional wxyz offset quat) -> vuer xyz euler."""
    m = _np_quat_xyzw_to_mat(np.asarray(orn)[XYZW_2_WXYZ]) @ MJ_TO_VUER_MAT
    if offset is not None:
        m = _np_quat_xyzw_to_mat(np.asarray(offset)[XYZW_2_WXYZ]) @ m
    return _np_mat_to_euler_xyz(m)


def vuer2mj_pos(pos: NDArray) -> NDArray:
    return VUER_TO_MJ_MAT @ np.asarray(pos, dtype=np.float64)


# scipy's internal quaternion for VUER_TO_MJ_ROT (= MJ_TO_VUER_ROT.inv());
# composing via the Hamilton product reproduces Rotation.__mul__ output
# including sign, which the reference's as_quat() exposes.
_VUER_TO_MJ_QUAT_XYZW: NDArray = np.array(
    [0.0, -np.sqrt(0.5), -np.sqrt(0.5), 0.0]
)


def _np_quat_mul_xyzw(p: NDArray, q: NDArray) -> NDArray:
    px, py, pz, pw = p
    qx, qy, qz, qw = q
    return np.array(
        [
            pw * qx + qw * px + py * qz - pz * qy,
            pw * qy + qw * py + pz * qx - px * qz,
            pw * qz + qw * pz + px * qy - py * qx,
            pw * qw - px * qx - py * qy - pz * qz,
        ]
    )


def vuer2mj_orn(orn) -> NDArray:
    """Vuer rotation -> quat reordered by WXYZ_2_XYZW (reference
    __init__.py:239-241 semantics, sign included). Accepts a scipy Rotation
    (the reference's signature), a 3x3 matrix, or an xyzw quat."""
    if hasattr(orn, "as_quat"):
        q_in = np.asarray(orn.as_quat(), dtype=np.float64)
    else:
        arr = np.asarray(orn, dtype=np.float64)
        q_in = _np_mat_to_quat_xyzw(arr) if arr.shape == (3, 3) else arr
    return _np_quat_mul_xyzw(q_in, _VUER_TO_MJ_QUAT_XYZW)[WXYZ_2_XYZW]

# Vuer teleop
VUER_IMG_QUALITY: int = 20

# real robot camera capture
CAMERA_FPS: int = 30
BGR_TO_RGB: NDArray = np.array([2, 1, 0], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Scene / task geometry (reference gym_kmanip/assets/scene.xml:14-21).
# The reference table is a mesh (tabletop.stl) not shipped in-repo; we model
# the tabletop as an axis-aligned box whose top surface sits at the bottom of
# the cube spawn range so spawned cubes land on it.
# ---------------------------------------------------------------------------
TABLE_POS: NDArray = np.array([0.0, 0.6, 0.5])
TABLE_TOP_Z: float = 0.6
TABLE_HALF_X: float = 0.6
TABLE_HALF_Y: float = 0.4
CUBE_HALF_SIZE: float = 0.02
CUBE_MASS: float = 0.05
CUBE_DIAG_INERTIA: float = 0.002
CUBE_FRICTION: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
CUBE_FRICTIONLOSS: float = 0.01
CUBE_INIT_POS: NDArray = np.array([0.2, 0.5, 0.65])

# Impedance-space contact parameters, derived from the reference cube's
# solref="0.01 1" (scene.xml:20): MuJoCo's soft constraint drives the
# penetration with reference acceleration  aref = -b*vel - kappa*pos  where
# b = 2/timeconst and kappa = 1/(timeconst^2 * dampratio^2), i.e. a
# CRITICALLY DAMPED return to zero penetration with tau = 10 ms, and the
# constraint force f = m_eff * (aref - a0) also absorbs whatever
# non-contact acceleration a0 (gravity, grasp squeeze) acts along the
# normal — so the resting cube sits at ~0 penetration, not at mg/k, and an
# impact produces no restitution bounce. Our contact model replicates that
# directly (dynamics/contacts.py) instead of a raw spring-damper penalty:
# a spring stiff enough for sub-mm rest penetration (k >= mg/0.1mm = 5 kN/m)
# ejects an impact-penetrated cube at ~30 N, which MuJoCo never does.
CONTACT_TIMECONST: float = 0.01  # s, scene.xml solref[0]
CONTACT_KAPPA: float = 1.0 / CONTACT_TIMECONST**2  # 1e4 s^-2
CONTACT_BETA: float = 2.0 / CONTACT_TIMECONST  # 200 s^-1
CONTACT_FRICTION_MU: float = 1.0
CONTACT_SLIP_VEL: float = 0.01  # m/s smoothing velocity for Coulomb friction

# Engine regularization (the reference XMLs specify no joint damping; this
# keeps the undamped kp=1000 position servos well-behaved under explicit
# integration)
JOINT_DAMPING: float = 1.0  # engine regularization; the golden generator patches the same damping onto the reference model (tools/make_golden_env.py) so parity traces share it

# Joint limits use MuJoCo's default limit-constraint impedance, solref
# (0.02, 1): the violating joint's acceleration is driven to
# aref = kappa*viol - beta*vel (critically damped, tau = 20 ms), NOT hard
# clamped — several reference home poses park joints OUTSIDE their range
# (torso left_arm x8_1 at -1.70 vs lo=-1.5708; gripper sliders at their
# stops), and MuJoCo lets them travel back through the limit with
# overshoot. A wide safety clamp at range +- LIMIT_SAFETY_MARGIN guards
# coarse-dt MPC rollouts only; the 2 ms plant never reaches it.
LIMIT_TIMECONST: float = 0.02
LIMIT_KAPPA: float = 1.0 / LIMIT_TIMECONST**2  # 2500 s^-2
LIMIT_BETA: float = 2.0 / LIMIT_TIMECONST  # 100 s^-1
# default solimp dmax (the XMLs set no solimp for limits, so the violating
# acceleration mixes a1 = (1-d)*a0 + d*aref with d = 0.95 at violations
# beyond the 1 mm width)
LIMIT_IMPEDANCE: float = 0.95
LIMIT_SAFETY_MARGIN: float = 0.5
# dual (force-space) Jacobi sweeps for limits + frictionloss in
# dynamics/engine.constraint_qacc; each sweep is one O(n^2) resolve on the
# substep's Cholesky factor
CONSTRAINT_ITERS: int = 3

# dof frictionloss is a SOFT constraint in MuJoCo (solreffriction (0.02, 1),
# solimp d0 = 0.9 at zero violation), NOT an exact dry-friction latch:
# forces below the bound produce velocity CREEP f = -(d/(1-d))*M*beta*v.
# Measured on the reference gripper (kp*range = 6.8 N applied vs
# frictionloss 30): real MuJoCo closes the 34 mm slider in ~1 s at
# ~0.1 m/s creep; an exact latch freezes it forever and castrates the
# gripper (round-3 fix; golden trace tests/golden/slider_friction_trace.npz)
FRICTION_BETA: float = 2.0 / (0.95 * LIMIT_TIMECONST)  # b = 2/(dmax*tau)
FRICTION_IMPEDANCE: float = 0.9  # solimp d0 at r = 0

# Cube velocity bounds: an energy cap that keeps coarse-dt (20 ms) MPC
# rollouts finite when penalty contacts go stiff (dt*sqrt(k/m) >> 1 there).
# The 2 ms plant never approaches these, so env/MuJoCo parity is unaffected.
CUBE_MAX_LINVEL: float = 4.0  # m/s
CUBE_MAX_ANGVEL: float = 50.0  # rad/s
