"""Dynamics engine tests: contact settling, PD holding, RNEA exactness,
batchability. The reference has no physics tests of its own (its backend is
the MuJoCo wheel, SURVEY.md §4); these are the golden-behavior equivalents
for our JAX engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import init_state, make_control_step
from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.ops import kinematics as kin


@pytest.fixture(scope="module")
def solo():
    return get_model("solo_arm")


@pytest.fixture(scope="module")
def solo_step(solo):
    return make_control_step(solo)


def _roll(step, s, ctrl, n):
    for _ in range(n):
        s, aux = step(s, ctrl)
    return s, aux


def test_cube_settles_on_table(solo, solo_step):
    s = init_state(solo)
    ctrl = jnp.asarray(solo.home_qpos[: solo.nu], dtype=jnp.float32)
    s, aux = _roll(solo_step, s, ctrl, 50)
    # rests at table top + half size, small penetration allowed
    assert abs(float(s.cube_pos[2]) - (k.TABLE_TOP_Z + k.CUBE_HALF_SIZE)) < 2e-3
    assert float(jnp.linalg.norm(s.cube_linvel)) < 1e-2
    assert bool(aux.touch_table)
    assert not bool(jnp.isnan(s.qpos).any())


def test_cube_off_table_falls_to_floor(solo, solo_step):
    s = init_state(solo, cube_pos=np.array([2.0, 2.0, 0.65]))
    ctrl = jnp.asarray(solo.home_qpos[: solo.nu], dtype=jnp.float32)
    s, aux = _roll(solo_step, s, ctrl, 80)
    assert abs(float(s.cube_pos[2]) - k.CUBE_HALF_SIZE) < 5e-3  # on the floor
    assert not bool(aux.touch_table)


def test_arm_holds_home_pose(solo, solo_step):
    s = init_state(solo)
    ctrl = jnp.asarray(solo.home_qpos[: solo.nu], dtype=jnp.float32)
    s, _ = _roll(solo_step, s, ctrl, 50)
    # kp=1000 servos hold within a few milli-rad (joint 7 has kp=0 and the
    # grip sliders fight frictionloss, so compare only strong servos)
    strong = np.asarray(solo.actuator_kp) >= 200
    drift = np.abs(np.array(s.qpos[: solo.nu]) - solo.home_qpos[: solo.nu])
    assert drift[strong].max() < 2e-2


def test_arm_tracks_small_target_change(solo, solo_step):
    s = init_state(solo)
    target = solo.home_qpos[: solo.nu].copy()
    target[1] += 0.1
    ctrl = jnp.asarray(target, dtype=jnp.float32)
    s, _ = _roll(solo_step, s, ctrl, 50)
    assert abs(float(s.qpos[1]) - target[1]) < 2e-2


def test_rnea_matches_ad_oracle():
    rng = np.random.RandomState(0)
    for name in ("solo_arm", "dual_arm", "torso"):
        m = get_model(name)
        lo = np.maximum(m.jnt_range[:, 0], -3)
        hi = np.minimum(m.jnt_range[:, 1], 3)
        for _ in range(3):
            q = jnp.asarray(rng.uniform(lo, hi), dtype=jnp.float32)
            v = jnp.asarray(rng.randn(m.nq) * 0.5, dtype=jnp.float32)
            b_rnea = kin.bias_forces(m, q, v)
            b_ad = kin.bias_forces_ad(m, q, v)
            np.testing.assert_allclose(
                np.array(b_rnea), np.array(b_ad), atol=1e-4, rtol=1e-4
            )


def test_mass_matrix_spd():
    rng = np.random.RandomState(1)
    for name in ("solo_arm", "dual_arm", "torso"):
        m = get_model(name)
        q = jnp.asarray(
            rng.uniform(m.jnt_range[:, 0].clip(-3), m.jnt_range[:, 1].clip(max=3)),
            dtype=jnp.float32,
        )
        M = np.array(kin.mass_matrix(m, q))
        np.testing.assert_allclose(M, M.T, atol=1e-5)
        assert np.linalg.eigvalsh(M).min() > 0


def test_vmap_batch_matches_single(solo):
    from gym_kmanip_tpu.dynamics.engine import control_step

    B = 4
    s0 = init_state(solo)
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), s0)
    ctrl = jnp.broadcast_to(
        jnp.asarray(solo.home_qpos[: solo.nu], dtype=jnp.float32), (B, solo.nu)
    )
    step_b = jax.jit(jax.vmap(lambda s, c: control_step(solo, s, c)))
    sb, auxb = step_b(batch, ctrl)
    s1, _ = control_step(solo, s0, ctrl[0])
    np.testing.assert_allclose(np.array(sb.qpos[0]), np.array(s1.qpos), atol=1e-5)
    np.testing.assert_allclose(np.array(sb.cube_pos[2]), np.array(s1.cube_pos), atol=1e-5)


def test_no_nan_under_random_ctrl(solo, solo_step):
    rng = np.random.RandomState(2)
    s = init_state(solo)
    lo, hi = solo.ctrl_range[:, 0], solo.ctrl_range[:, 1]
    for _ in range(k.MAX_EPISODE_STEPS):
        ctrl = jnp.asarray(rng.uniform(lo, hi), dtype=jnp.float32)
        s, _ = solo_step(s, ctrl)
    assert not bool(jnp.isnan(s.qpos).any())
    assert not bool(jnp.isnan(s.cube_pos).any())
    assert float(jnp.abs(s.qvel).max()) < 100.0


def test_fingertip_touch_detection(solo):
    """A cube overlapping a fingertip registers contact and gets pushed."""
    from gym_kmanip_tpu.dynamics import contacts
    from gym_kmanip_tpu.dynamics.engine import control_step, _tip_state
    from gym_kmanip_tpu.ops.kinematics import fk

    s0 = init_state(solo)
    xpos, xquat, axis_w = fk(solo, s0.qpos)
    tip_pos, tip_vel, _, tip_rad = _tip_state(solo, xpos, xquat, axis_w, s0.qvel)
    cube_pos = np.array(tip_pos[0])  # tip buried in the cube
    s = init_state(solo, cube_pos=cube_pos)
    con = contacts.contact_forces(
        tip_pos, tip_vel, tip_rad, s.cube_pos, s.cube_quat,
        s.cube_linvel, s.cube_angvel,
    )
    assert bool(con.touch_tip[0])
    assert float(jnp.linalg.norm(con.force_cube)) > 0
    # and dynamically the penalty force accelerates the cube away
    ctrl = jnp.asarray(solo.home_qpos[: solo.nu], dtype=jnp.float32)
    s1, _ = control_step(solo, s, ctrl)
    assert float(jnp.linalg.norm(s1.cube_linvel)) > 1e-3


def test_dual_and_torso_step():
    for name in ("dual_arm", "torso"):
        m = get_model(name)
        step = make_control_step(m)
        s = init_state(m)
        ctrl = jnp.asarray(m.home_qpos[: m.nu], dtype=jnp.float32)
        s, aux = step(s, ctrl)
        assert not bool(jnp.isnan(s.qpos).any())
        assert aux.site_pos.shape == (len(m.sites), 3)
