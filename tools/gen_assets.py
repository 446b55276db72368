"""Emit the shipped MJCF assets from the built-in robot model tables.

The reference ships its robots as MJCF trees (assets/_env_*.xml +
*_body.xml); our equivalent single-source-of-truth is
gym_kmanip_tpu/assets/{solo_arm,dual_arm,torso}.xml — self-contained,
mesh-free MJCF (scene + robot tree + inertials + home keyframe + cube +
mocap bodies) that models/mjcf.py loads into the RobotModel every other
layer jits against, and that real MuJoCo can also compile directly.

This tool serializes the hand-derived tables in models/_chains.py (data
transcribed from the reference XMLs with declared provenance) into those
files. Re-run after editing the tables:  python tools/gen_assets.py
It round-trip-verifies each emitted file through the loader before
writing, and (when the mujoco wheel is importable) compiles each file with
real MuJoCo as a syntax check.
"""

import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

# host-side tool: the tiny un-jitted quaternion ops in model composition
# need no device — force CPU
jax.config.update("jax_platforms", "cpu")

from gym_kmanip_tpu import constants as k  # noqa: E402
from gym_kmanip_tpu.models import spec as spec_mod  # noqa: E402

OUT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "gym_kmanip_tpu", "assets"
)


def _fmt(x) -> str:
    # %.17g: bit-exact float64 round trip. The env-parity contract depends
    # on it — the IK is an exact scipy-TRF replica whose iterate path (and
    # therefore the recorded golden traces) is sensitive to model values at
    # the last bit; 9 significant digits drifted solo/dual parity from
    # ~8e-4 rad to 0.68.
    arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
    return " ".join(f"{float(v):.17g}" for v in arr)


def _scene(world: ET.Element, model) -> None:
    """Table, lighting, world cameras, free cube, mocap hand targets."""
    ET.SubElement(world, "light", dict(pos="0 0 3", dir="0 0 -1"))
    for cam in model.cameras:
        if cam.parent == -1:
            ET.SubElement(
                world, "camera",
                dict(name=cam.name, pos=_fmt(cam.pos), fovy=_fmt(cam.fovy),
                     mode="targetbody", target="table"),
            )
    table = ET.SubElement(world, "body", dict(name="table", pos=_fmt(k.TABLE_POS)))
    half_z = (k.TABLE_TOP_Z - k.TABLE_POS[2]) if k.TABLE_TOP_Z > k.TABLE_POS[2] else 0.05
    ET.SubElement(
        table, "geom",
        dict(name="table", type="box",
             size=f"{k.TABLE_HALF_X} {k.TABLE_HALF_Y} {half_z / 2}",
             pos=f"0 0 {half_z / 2}", rgba="0.55 0.42 0.28 1"),
    )
    for i in range(model.mocap_pos0.shape[0]):
        name = "hand_r" if i == k.MOCAP_ID_R else "hand_l"
        hand = ET.SubElement(
            world, "body",
            dict(name=name, mocap="true", pos=_fmt(model.mocap_pos0[i]),
                 quat=_fmt(model.mocap_quat0[i])),
        )
        ET.SubElement(
            hand, "site",
            dict(name=f"{name}_site", type="sphere", size="0.01",
                 rgba="1 0 0 0.3"),
        )
    # the free cube goes LAST so its 7 qpos values trail the robot's in the
    # keyframe (document order = qpos order in MuJoCo)
    cube = ET.SubElement(
        world, "body", dict(name="cube", pos=_fmt(k.CUBE_INIT_POS))
    )
    ET.SubElement(cube, "freejoint", dict(name="cube_free"))
    ET.SubElement(
        cube, "geom",
        dict(name="cube", type="box", size=_fmt([k.CUBE_HALF_SIZE] * 3),
             mass=_fmt(k.CUBE_MASS), friction=_fmt(k.CUBE_FRICTION),
             solref=f"{k.CONTACT_TIMECONST} 1", rgba="0.8 0.2 0.2 1"),
    )


def _robot(world: ET.Element, model) -> None:
    children = {i: [] for i in range(-1, model.nq)}
    for i in range(model.nq):
        children[int(model.parent[i])].append(i)

    def emit(parent_el: ET.Element, i: int) -> None:
        jname = model.joint_names[i]
        body = ET.SubElement(
            parent_el, "body",
            dict(name=f"body_{jname}", pos=_fmt(model.jnt_pos[i]),
                 quat=_fmt(model.jnt_quat[i])),
        )
        ET.SubElement(
            body, "inertial",
            dict(pos=_fmt(model.body_com[i]), mass=_fmt(model.body_mass[i]),
                 diaginertia=_fmt(model.body_inertia[i])),
        )
        jtype = "slide" if model.jnt_type[i] == spec_mod.SLIDE else "hinge"
        ET.SubElement(
            body, "joint",
            dict(name=jname, type=jtype, pos="0 0 0", axis="0 0 1",
                 range=_fmt(model.jnt_range[i]),
                 frictionloss=_fmt(model.jnt_frictionloss[i]),
                 armature=_fmt(model.armature[i])),
        )
        for t_idx, tip in enumerate(model.fingertips):
            if tip.parent == i:
                ET.SubElement(
                    body, "geom",
                    dict(name=f"tip_{tip.side}_{t_idx}", type="sphere",
                         size=_fmt(tip.radius), pos=_fmt(tip.pos),
                         rgba="0.2 0.2 0.2 1"),
                )
        for s in model.sites:
            if s.parent == i:
                marker = ET.SubElement(
                    body, "body",
                    dict(name=s.name, pos=_fmt(s.pos), quat=_fmt(s.quat)),
                )
                ET.SubElement(
                    marker, "site",
                    dict(name=s.name, type="sphere", size="0.005",
                         rgba="0 1 0 0.5"),
                )
        for cam in model.cameras:
            if cam.parent == i:
                ET.SubElement(
                    body, "camera",
                    dict(name=cam.name, pos=_fmt(cam.pos),
                         fovy=_fmt(cam.fovy), mode="targetbody",
                         target=cam.target_site),
                )
        for c in children[i]:
            emit(body, c)

    for r in children[-1]:
        emit(world, r)


def build_asset_xml(model) -> str:
    root = ET.Element("mujoco", dict(model=model.name))
    ET.SubElement(
        root, "option",
        dict(timestep=_fmt(k.PHYSICS_TIMESTEP), gravity="0 0 -9.81"),
    )
    world = ET.SubElement(root, "worldbody")
    _robot(world, model)
    _scene(world, model)
    act = ET.SubElement(root, "actuator")
    for i in range(model.nu):
        attrs = dict(
            name=f"act_{model.joint_names[i]}", joint=model.joint_names[i],
            kp=_fmt(model.actuator_kp[i]), ctrlrange=_fmt(model.ctrl_range[i]),
        )
        if np.all(np.isfinite(model.force_range[i])):
            attrs["forcerange"] = _fmt(model.force_range[i])
        ET.SubElement(act, "position", attrs)
    kf = ET.SubElement(root, "keyframe")
    cube_qpos = np.concatenate([k.CUBE_INIT_POS, [1.0, 0, 0, 0]])
    ET.SubElement(
        kf, "key",
        dict(name="home", qpos=_fmt(np.concatenate([model.home_qpos, cube_qpos]))),
    )
    ET.indent(root)
    return ET.tostring(root, encoding="unicode") + "\n"


def main():
    # build from the _chains tables directly (bypasses the asset-backed
    # registry in models/__init__.py so regeneration never reads what it is
    # about to write)
    from gym_kmanip_tpu.models import _table_models

    os.makedirs(OUT_DIR, exist_ok=True)
    from gym_kmanip_tpu.models.mjcf import load_mjcf

    for name, builder in _table_models().items():
        model = builder()
        xml = build_asset_xml(model)
        path = os.path.join(OUT_DIR, f"{name}.xml")
        with open(path, "w") as f:
            f.write(xml)
        # round-trip verification through the loader: BIT-exact (see _fmt)
        loaded = load_mjcf(path, name=name)
        assert loaded.nq == model.nq and loaded.nu == model.nu, name
        np.testing.assert_array_equal(loaded.jnt_pos, model.jnt_pos)
        np.testing.assert_array_equal(loaded.jnt_quat, model.jnt_quat)
        np.testing.assert_array_equal(loaded.home_qpos, model.home_qpos)
        np.testing.assert_array_equal(loaded.body_mass, model.body_mass)
        np.testing.assert_array_equal(loaded.body_com, model.body_com)
        np.testing.assert_array_equal(loaded.body_inertia, model.body_inertia)
        np.testing.assert_array_equal(loaded.armature, model.armature)
        np.testing.assert_array_equal(loaded.jnt_range, model.jnt_range)
        for s in model.sites:
            np.testing.assert_array_equal(loaded.site(s.name).pos, s.pos)
            np.testing.assert_array_equal(loaded.site(s.name).quat, s.quat)
        assert loaded.joint_names == model.joint_names, name
        print(f"wrote {path}: nq={model.nq} nu={model.nu}, round-trip OK")
        try:
            import mujoco

            mujoco.MjModel.from_xml_path(path)
            print(f"  mujoco compile check OK")
        except ImportError:
            pass


if __name__ == "__main__":
    main()
