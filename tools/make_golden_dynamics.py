"""Generate golden *dynamics* traces from real MuJoCo for engine validation.

Extends tools/make_golden.py (kinematics) to full trajectories: the solo-arm
model tracks a sequence of position-servo targets for 1 s of sim time, and
we record qpos/qvel at every control step. The test suite then replays the
same targets through our engine and checks the BASELINE "control
deviation" metric (<1e-3 rad without contact).

To make the comparison well-posed the golden XML is built to match the
engine's modeling assumptions exactly (both are approximations of the same
unshipped reality -- the reference's STL-derived inertias are .gitignored):
  * per-joint inertials from the engine's class-based estimates
    (models/spec.py _MASS_BY_CLASS, com, gyration radius)
  * armature + engine JOINT_DAMPING on every joint
  * frictionloss stripped (MuJoCo solves it as a constraint, the engine as
    smooth Coulomb -- excluded from this parity check)
  * no cube, no contact (contact parity is validated behaviorally in
    tests/test_dynamics.py)

Run:  python tools/make_golden_dynamics.py
"""

import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.make_golden import build_xml  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")

N_CTRL_STEPS = 50  # 1 s at 50 Hz
SEED = 7


def patch_xml(xml: str) -> str:
    from gym_kmanip_tpu import constants as k
    from gym_kmanip_tpu.models import get_model

    model = get_model("solo_arm")
    root = ET.fromstring(xml)

    # strip the cube (free joint) so qpos is robot-only and contact-free
    for wb in root.findall("worldbody"):
        for body in list(wb.findall("body")):
            if body.get("name") == "cube":
                wb.remove(body)

    # disable joint-limit constraints: limit semantics (MuJoCo soft
    # constraint vs engine penalty+clamp) are validated behaviorally, not
    # in this smooth-dynamics trace. The engine side widens jnt_range to
    # match (tests/test_dynamics_parity.py).
    opt = root.find("option")
    if opt is None:
        opt = ET.SubElement(root, "option")
    flag = opt.find("flag")
    if flag is None:
        flag = ET.SubElement(opt, "flag")
    flag.set("limit", "disable")

    # index joints by name -> engine joint id
    name2id = {n: i for i, n in enumerate(model.joint_names)}

    def visit(body):
        j = body.find("joint")
        if j is not None and j.get("name") in name2id:
            i = name2id[j.get("name")]
            j.set("damping", str(k.JOINT_DAMPING))
            j.set("armature", str(model.armature[i]))
            if "frictionloss" in j.attrib:
                del j.attrib["frictionloss"]
            ine = body.find("inertial")
            if ine is None:
                ine = ET.SubElement(body, "inertial")
            ine.set("pos", " ".join(str(x) for x in model.body_com[i]))
            ine.set("mass", str(model.body_mass[i]))
            ine.set("diaginertia", " ".join(str(x) for x in model.body_inertia[i]))
        for ch in body.findall("body"):
            visit(ch)

    for wb in root.findall("worldbody"):
        for b in wb.findall("body"):
            visit(b)
    return ET.tostring(root, encoding="unicode")


def main():
    import mujoco

    from gym_kmanip_tpu import constants as k
    from gym_kmanip_tpu.models import get_model

    kmodel = get_model("solo_arm")
    xml = patch_xml(build_xml("_env_solo_arm.xml"))
    mj = mujoco.MjModel.from_xml_string(xml)
    data = mujoco.MjData(mj)
    assert mj.nq == kmodel.nq, (mj.nq, kmodel.nq)
    n_sub = int(round(k.CONTROL_TIMESTEP / mj.opt.timestep))

    rng = np.random.RandomState(SEED)
    home = np.asarray(kmodel.home_qpos, dtype=np.float64).copy()
    # park the gripper sliders mid-range: their home (0.005) IS the upper
    # joint limit, and limit semantics (MuJoCo constraint vs engine clamp)
    # are out of scope for this smooth-dynamics trace
    slide = kmodel.jnt_type == 1
    home[slide] = -0.012
    data.qpos[:] = home
    data.ctrl[:] = home[: kmodel.nu]
    mujoco.mj_forward(mj, data)

    # target sequence: smooth random walk on the interior arm joints only
    # (joints 0-6); sliders and the kp=0 servo hold their start pose so no
    # limit machinery engages on either side
    targets = np.tile(home[: kmodel.nu], (N_CTRL_STEPS, 1))
    excite = list(range(7))
    t = home[excite].copy()
    lo = kmodel.ctrl_range[excite, 0] + 0.15 * (
        kmodel.ctrl_range[excite, 1] - kmodel.ctrl_range[excite, 0]
    )
    hi = kmodel.ctrl_range[excite, 1] - 0.15 * (
        kmodel.ctrl_range[excite, 1] - kmodel.ctrl_range[excite, 0]
    )
    for i in range(N_CTRL_STEPS):
        t = np.clip(t + rng.uniform(-0.05, 0.05, len(excite)), lo, hi)
        targets[i, excite] = t

    qpos_trace = np.zeros((N_CTRL_STEPS, kmodel.nq))
    qvel_trace = np.zeros((N_CTRL_STEPS, kmodel.nq))
    for i in range(N_CTRL_STEPS):
        data.ctrl[:] = targets[i]
        for _ in range(n_sub):
            mujoco.mj_step(mj, data)
        qpos_trace[i] = data.qpos
        qvel_trace[i] = data.qvel

    np.savez(
        os.path.join(OUT, "solo_arm_dynamics.npz"),
        targets=targets,
        qpos=qpos_trace,
        qvel=qvel_trace,
        home=home,
        timestep=mj.opt.timestep,
        n_sub=n_sub,
    )
    print(f"wrote solo_arm_dynamics.npz: {N_CTRL_STEPS} ctrl steps, n_sub={n_sub}")
    print("final qpos:", qpos_trace[-1].round(4))


if __name__ == "__main__":
    main()
