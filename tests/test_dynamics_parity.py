"""Dynamics parity vs real MuJoCo golden traces.

Replays the golden position-servo target sequence
(tests/golden/solo_arm_dynamics.npz, generated by
tools/make_golden_dynamics.py from the reference MJCF compiled with matched
inertials/damping) through the engine and checks the BASELINE
"control deviation" metric: arm joints within 1e-3 rad of MuJoCo over a
1 s contact-free tracking rollout.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.dynamics.engine import substep
from gym_kmanip_tpu.models import get_model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "solo_arm_dynamics.npz")
ARM_JOINTS = list(range(7))  # interior joints; sliders ram their limits
                             # (constraint vs hard-clamp semantics differ)


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden trace missing")
def test_control_deviation_vs_mujoco():
    data = np.load(GOLDEN)
    model = get_model("solo_arm")
    # the golden XML strips frictionloss (MuJoCo treats it as a constraint,
    # the engine as smooth Coulomb) and disables joint limits (constraint vs
    # penalty+clamp semantics); mirror both here
    model = dataclasses.replace(
        model,
        jnt_frictionloss=np.zeros_like(model.jnt_frictionloss),
        jnt_range=np.tile(np.array([-1e6, 1e6]), (model.nq, 1)),
    )
    n_sub = int(data["n_sub"])
    dt = float(data["timestep"])
    f = jnp.float32

    state = SimState(
        qpos=jnp.asarray(data["home"], dtype=f),
        qvel=jnp.zeros(model.nq, dtype=f),
        ctrl=jnp.asarray(data["home"][: model.nu], dtype=f),
        cube_pos=jnp.asarray([2.0, 2.0, 0.02], dtype=f),  # unused (contact off)
        cube_quat=jnp.asarray([1.0, 0, 0, 0], dtype=f),
        cube_linvel=jnp.zeros(3, dtype=f),
        cube_angvel=jnp.zeros(3, dtype=f),
        time=jnp.zeros((), dtype=f),
    )

    @jax.jit
    def ctrl_step(s, target):
        s = s._replace(ctrl=target)

        def body(si, _):
            s2, _aux = substep(model, si, dt, contact=False)
            return s2, None

        s, _ = jax.lax.scan(body, s, None, length=n_sub)
        return s, s.qpos

    targets = jnp.asarray(data["targets"], dtype=f)

    def scan_all(s):
        return jax.lax.scan(ctrl_step, s, targets)

    _, qpos_trace = jax.jit(scan_all)(state)
    qpos_trace = np.asarray(qpos_trace)
    ref = data["qpos"]

    dev = np.abs(qpos_trace[:, ARM_JOINTS] - ref[:, ARM_JOINTS])
    max_dev = dev.max()
    print(f"max arm-joint deviation vs MuJoCo over 1 s: {max_dev:.2e} rad")
    assert max_dev < 1e-3, max_dev


def test_slider_friction_creep_matches_mujoco():
    """dof frictionloss is a SOFT constraint (round-3 fix): the reference
    gripper's kp*range = 6.8 N sits UNDER frictionloss = 30, and real
    MuJoCo still closes the 34 mm slider in ~1 s via regularized-friction
    creep (golden: tools snippet in slider_friction_trace.npz). An exact
    dry-friction latch (the old model) freezes it forever — this trace
    pins the creep rate and final closure."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.dynamics.engine import substep
    from gym_kmanip_tpu.models import get_model

    model = get_model("solo_arm")
    g = np.load(
        os.path.join(
            os.path.dirname(__file__), "golden", "slider_friction_trace.npz"
        )
    )
    state = init_state(model, cube_pos=np.array([0.4, 0.9, 0.62]))
    q0 = jnp.zeros_like(jnp.asarray(state.qpos)).at[8].set(0.005).at[9].set(0.005)
    state = state._replace(
        qpos=q0, ctrl=q0.at[8].set(-0.029).at[9].set(-0.029)
    )

    @jax.jit
    def run(state):
        def body(s, _):
            s2, _aux = substep(model, s, 0.002, contact=False, unrolled_solve=False)
            return s2, s2.qpos
        return jax.lax.scan(body, state, None, length=500)[1]

    qs = np.asarray(run(state))
    gq = g["qpos"]
    for t in (49, 149, 499):
        np.testing.assert_allclose(
            qs[t][8:10], gq[t][g["qadr"]], atol=1.5e-3,
            err_msg=f"slider creep diverged from MuJoCo at step {t}",
        )
    # the gripper must actually CLOSE (the latch bug kept it at +0.005)
    assert qs[-1][8] < -0.028 and qs[-1][9] < -0.024
