"""No jitted program may capture a pre-existing DEVICE array as a constant.

A device array captured by a jitted closure becomes a hidden input of
the compiled program: it is kept alive as long as the program is, and its
values never reach the HLO as literals XLA can fold. Host constants (python scalars / numpy arrays)
are baked into the HLO as literals; arrays passed as ARGUMENTS are
explicit inputs.

The rule this suite enforces: factory functions (`make_*`) and module
scope must keep constants in numpy; `jnp.asarray` conversions belong
INSIDE the traced function, where they become HLO literals.

Detection: `jax.make_jaxpr(fn)(*args).consts` — closure-captured device
buffers surface as `jax.Array` consts, host literals as numpy arrays.
"""

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.dynamics.engine import make_control_step, substep
from gym_kmanip_tpu.env.config import CONFIGS
from gym_kmanip_tpu.env.task import make_task
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi, mppi_solve
from gym_kmanip_tpu.render.raycast import render_camera


def _collect_device_consts(obj, acc, seen):
    """Recursively collect jax.Array consts from a (Closed)Jaxpr tree.

    Inner pjit/shard_map/cond/scan jaxprs carry their OWN consts that do
    not surface in the top-level `.consts` — they still become hidden
    device-buffer inputs of the compiled executable, so they must be
    walked too."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    consts = getattr(obj, "consts", None)
    if consts is not None:
        acc.extend(c for c in consts if isinstance(c, jax.Array))
    jaxpr = getattr(obj, "jaxpr", obj)
    eqns = getattr(jaxpr, "eqns", None)
    if eqns is None:
        return
    for eqn in eqns:
        for v in eqn.params.values():
            for item in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(item, "eqns") or hasattr(item, "jaxpr"):
                    _collect_device_consts(item, acc, seen)


def assert_no_device_consts(name, fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    bad = []
    _collect_device_consts(jaxpr, bad, set())
    assert not bad, (
        f"{name}: jitted closure captures {len(bad)} device array(s) "
        f"(shapes {[c.shape for c in bad[:8]]}) — move the jnp.asarray "
        f"inside the traced function or pass it as an argument; device "
        f"closure constants become hidden inputs of every program."
    )


def _action_dict(cfg) -> Dict[str, jax.Array]:
    """Zero action with the env shell's exact shapes (env_base.py spaces)."""
    act = {}
    for n in cfg.act_list:
        if n.endswith(("_pos", "_orn")):
            act[n] = jnp.zeros((3,), jnp.float32)
        elif n == "q_pos_r":
            act[n] = jnp.zeros((len(cfg.q_id_r_mask),), jnp.float32)
        elif n == "q_pos_l":
            act[n] = jnp.zeros((len(cfg.q_id_l_mask),), jnp.float32)
        else:  # grip_*
            act[n] = jnp.zeros((1,), jnp.float32)
    return act


def test_substep_and_control_step_clean():
    model = get_model("solo_arm")
    s0 = init_state(model)
    assert_no_device_consts(
        "substep", lambda s: substep(model, s, k.PHYSICS_TIMESTEP), s0
    )
    ctrl = jnp.asarray(model.home_qpos[: model.nu], jnp.float32)
    cs = make_control_step(model)
    assert_no_device_consts("control_step", cs, s0, ctrl)


def test_mppi_solve_clean():
    model = get_model("solo_arm")
    s0 = init_state(model)
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    cfg = MPPIConfig(horizon=5, n_samples=4, n_iters=1, n_substeps=1)
    ms0 = init_mppi(model, cfg)
    assert_no_device_consts(
        "mppi_solve", lambda ms, s: mppi_solve(model, cfg, ms, s, cost_fn),
        ms0, s0,
    )


def test_sharded_mppi_solver_clean():
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver

    model = get_model("solo_arm")
    s0 = init_state(model)
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = MPPIConfig(
        horizon=5, n_samples=2 * n_dev, n_iters=1, n_substeps=1
    )
    solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
    ms0 = init_mppi(model, cfg)
    assert_no_device_consts("sharded_mppi_solver", solver, ms0, s0)


@pytest.mark.parametrize("env_name", sorted(CONFIGS))
def test_task_fns_clean(env_name):
    cfg = CONFIGS[env_name]
    reset_fn, step_fn, model = make_task(cfg)
    cube0 = jnp.asarray([0.2, 0.5, 0.65], jnp.float32)
    assert_no_device_consts(f"{env_name} reset", reset_fn, cube0)
    out = reset_fn(cube0)
    act = _action_dict(cfg)
    parts = getattr(step_fn, "jit_parts", None)
    if parts is None:
        assert_no_device_consts(f"{env_name} step", step_fn, out.state, act)
    else:
        # split host-IK pipeline (env/task.py make_task, cfg.ik_host64):
        # the Python step_fn is not traceable; trace its jitted pieces
        goals_jit, core_jit = parts
        assert_no_device_consts(f"{env_name} goals", goals_jit, out.state, act)
        goals = goals_jit(out.state, act)
        # solutions with the right per-arm shapes from the config masks
        sols = {}
        for side in goals:
            mask = getattr(cfg, f"q_id_{side}_mask")
            n = len(tuple(mask))
            sols[side] = (
                np.zeros((n,), np.float32), np.zeros((n,), np.float32)
            )
        assert_no_device_consts(
            f"{env_name} core", core_jit, out.state, act, sols
        )


def test_render_camera_clean():
    model = get_model("solo_arm")
    s0 = init_state(model)
    assert_no_device_consts(
        "render_camera",
        lambda q, cp, cq: render_camera(model, "top", q, cp, cq, 16, 16),
        s0.qpos, s0.cube_pos, s0.cube_quat,
    )


def test_ilqr_solver_pieces_clean():
    from gym_kmanip_tpu.solvers.ilqr import (
        ILQRConfig, make_ilqr_solver, unflatten_state,
    )

    model = get_model("solo_arm")
    s0 = init_state(model)

    def cost_xu(x, u):
        s = unflatten_state(model, x, s0)
        return jnp.sum(s.qvel ** 2) + 1e-3 * jnp.sum(u ** 2)

    cfg = ILQRConfig(horizon=4, n_iters=1, contact=False)
    solver = make_ilqr_solver(model, cfg, cost_xu)
    us = jnp.tile(
        jnp.asarray(model.home_qpos[: model.nu], jnp.float32), (4, 1)
    )
    assert_no_device_consts("ilqr_solver", solver, s0, us)


def test_ik_trf_clean():
    from gym_kmanip_tpu.env.config import CONFIGS
    from gym_kmanip_tpu.solvers.ik import ik_trf

    cfg = CONFIGS["KManipSoloArm"]
    model = get_model(cfg.mjcf_filename)
    s0 = init_state(model)
    q_home = jnp.asarray(cfg.q_pos_home, jnp.float32)
    goal_p = jnp.asarray([0.2, 0.5, 0.7], jnp.float32)
    goal_q = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    assert_no_device_consts(
        "ik_trf",
        lambda qp, gp, gq, qh: ik_trf(
            model, qp, gp, gq, qh, qh,
            q_mask=tuple(cfg.q_id_r_mask), site_name="eer_site",
        ),
        s0.qpos, goal_p, goal_q, q_home,
    )


def test_vec_env_step_clean():
    from gym_kmanip_tpu.env.vec_env import KManipVecEnv

    ve = KManipVecEnv("KManipSoloArm", num_envs=2, seed=0)
    ve.reset()
    cfg = CONFIGS["KManipSoloArm"]
    act = {
        n: jnp.broadcast_to(v, (2,) + v.shape)
        for n, v in _action_dict(cfg).items()
    }
    key = jax.random.PRNGKey(0)
    assert_no_device_consts(
        "vec_env step_all", ve._step_all, ve._states, act, ve._steps, key
    )


def test_costparams_defaults_are_host_values():
    for name, v in CostParams()._asdict().items():
        assert not isinstance(v, jax.Array), (
            f"CostParams.{name} default is a device array — module-scope "
            f"jnp defaults become jit closure constants (slow-mode trigger)"
        )
