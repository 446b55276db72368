"""Robot model registry — asset-backed.

The three Stompy morphologies are shipped as self-contained mesh-free MJCF
files (gym_kmanip_tpu/assets/{solo_arm,dual_arm,torso}.xml, regenerated by
tools/gen_assets.py) and built through the models/mjcf.py loader, the same
path users take to import their OWN robots — the JAX analog of the
reference's `mujoco.Physics.from_xml_path` compile
(/root/reference/gym_kmanip/env_sim.py:208) and its assets/templates
import workflow. Registry keys match the MJCF filenames the reference uses
to select robots (gym_kmanip/__init__.py:18-20) plus short names.

models/_chains.py holds the original hand-derived tables; it is no longer
the production source (tests/test_mjcf_loader.py cross-checks the loaded
assets against it).
"""

import os
from functools import lru_cache

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.models.spec import (  # noqa: F401 (re-exported)
    HINGE,
    SLIDE,
    CameraSpec,
    FingertipSpec,
    RobotModel,
    SiteSpec,
    build_model,
)


@lru_cache(maxsize=None)
def _from_asset(name: str) -> RobotModel:
    from gym_kmanip_tpu.models.mjcf import load_mjcf

    return load_mjcf(os.path.join(k.ASSETS_DIR, f"{name}.xml"), name=name)


def solo_arm() -> RobotModel:
    return _from_asset("solo_arm")


def dual_arm() -> RobotModel:
    return _from_asset("dual_arm")


def torso() -> RobotModel:
    return _from_asset("torso")


def _table_models():
    """The hand-derived _chains builders (cross-check / regeneration source
    for tools/gen_assets.py) keyed by short name."""
    from gym_kmanip_tpu.models import _chains as ch
    import numpy as np
    from gym_kmanip_tpu.models.spec import quat_from_euler_xyz_np

    base_r = [((0, 0, 0.5), ch.IDENT), ((0.5, 0.6, 0), ch.IDENT)]
    base_l = [((0, 0, 0.5), ch.IDENT), ((-0.5, 0.6, 0), ch.IDENT)]

    def _grip_cam(name, parent, target):
        return dict(
            name=name, parent=parent, pos=(0, 0.05, 0), fovy=20,
            target_site=target,
        )

    def solo():
        return build_model(
            name="solo_arm",
            joints=ch.right_arm_joints(base_r, 0),
            sites=[ch.right_arm_site(0)],
            cameras=ch.world_cameras() + [_grip_cam("grip_r", 6, "eer_site")],
            fingertips=ch.right_arm_fingertips(0),
            actuators=ch.right_arm_actuators(),
            home_qpos=k.Q_SOLO_ARM_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0]]),
        )

    def dual():
        return build_model(
            name="dual_arm",
            joints=ch.right_arm_joints(base_r, 0) + ch.left_arm_joints(base_l, 10),
            sites=[ch.right_arm_site(0), ch.left_arm_site(10)],
            cameras=ch.world_cameras()
            + [_grip_cam("grip_r", 6, "eer_site"),
               _grip_cam("grip_l", 16, "eel_site")],
            fingertips=ch.right_arm_fingertips(0) + ch.left_arm_fingertips(10),
            actuators=ch.right_arm_actuators() + ch.left_arm_actuators(),
            home_qpos=k.Q_DUAL_ARM_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6], [-0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]]),
        )

    def torso_m():
        root_frames = [
            ((0, 0.2, 0.7), ch.IDENT),
            ((0, 0, 0), quat_from_euler_xyz_np((0, 0, 3.1416))),
        ]
        return build_model(
            name="torso",
            joints=ch.torso_joints(root_frames),
            sites=ch.torso_sites(),
            cameras=ch.world_cameras()
            + [_grip_cam("grip_r", 10, "eer_site"),
               _grip_cam("grip_l", 19, "eel_site")],
            fingertips=ch.torso_fingertips(),
            actuators=ch.torso_actuators(),
            home_qpos=k.Q_TORSO_HOME,
            mocap_pos0=np.array([[0.2, 0.6, 0.6], [-0.2, 0.6, 0.6]]),
            mocap_quat0=np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]]),
        )

    return {"solo_arm": solo, "dual_arm": dual, "torso": torso_m}


_REGISTRY = {
    k.SOLO_ARM_MJCF: solo_arm,
    k.DUAL_ARM_MJCF: dual_arm,
    k.TORSO_MJCF: torso,
    "solo_arm": solo_arm,
    "dual_arm": dual_arm,
    "torso": torso,
}


def get_model(key: str) -> RobotModel:
    """Built-in robot by MJCF filename or short name, or a user robot by
    path to any MJCF file the loader subset covers."""
    fn = _REGISTRY.get(key)
    if fn is not None:
        return fn()
    if os.path.exists(key):
        from gym_kmanip_tpu.models.mjcf import load_mjcf

        return load_mjcf(key)
    raise KeyError(key)
