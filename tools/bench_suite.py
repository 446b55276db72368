"""Full benchmark suite (BASELINE.md metrics beyond the bench.py headline).

Prints one JSON line per metric:
  * MPPI solves/sec/chip at H=50 and H=100 (configs 2 and the headline)
  * DualArm bimanual MPPI solves/sec (config 3)
  * Torso iLQR solve time at H=100 (config 4)
  * Vision-MPC renders/sec (config 5)
  * rollout-sharding scaling efficiency across the local device mesh
    (1 -> N devices; with one card this runs on the virtual CPU mesh --
    set XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu)

Run: python tools/bench_suite.py [--quick]
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost, ee_tracking_cost
from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi, mppi_solve
from gym_kmanip_tpu.ops import kinematics as kin

QUICK = "--quick" in sys.argv


def report(metric, value, unit, vs=None, **extra):
    print(json.dumps({"metric": metric, "value": round(value, 3), "unit": unit,
                      **({"vs_baseline": round(vs, 3)} if vs is not None else {}),
                      **extra}),
          flush=True)


def timed_scan_solves(model, cfg, cost_fn, n_solves):
    ms = init_mppi(model, cfg)
    ss = init_state(model)

    @jax.jit
    def run(ms, ss):
        def body(m, _):
            m2, u0, J = mppi_solve(model, cfg, m, ss, cost_fn)
            return m2, J

        return jax.lax.scan(body, ms, None, length=n_solves)

    out = run(ms, ss)
    jax.block_until_ready(out[1])
    ms2 = ms._replace(rng=jax.random.fold_in(ms.rng, 1))
    t0 = time.time()
    out = run(ms2, ss)
    jax.block_until_ready(out[1])
    return (time.time() - t0) / n_solves


def mppi_benches():
    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    n = 3 if QUICK else 20
    for H in (50, 100):
        cfg = MPPIConfig(horizon=H, n_samples=64 if QUICK else 256, n_iters=1)
        dt = timed_scan_solves(model, cfg, cost_fn, n)
        report(f"mppi_solves_per_sec_chip_H{H}", 1.0 / dt, "solves/s",
               (1.0 / dt) / 50.0 if H == 50 else None)


def dual_arm_bench():
    model = get_model("dual_arm")
    s0 = init_state(model)
    xp, xq, _ = kin.fk(model, s0.qpos)
    eer, _ = kin.site_pose(model, xp, xq, "eer_site")
    eel, _ = kin.site_pose(model, xp, xq, "eel_site")
    goal_r = eer + jnp.asarray([0.0, 0.03, -0.03])
    goal_l = eel + jnp.asarray([0.0, 0.03, -0.03])

    def cost_fn(s, aux, u):
        ir, il = model.site_index("eer_site"), model.site_index("eel_site")
        return (100.0 * jnp.sum((aux.site_pos[ir] - goal_r) ** 2)
                + 100.0 * jnp.sum((aux.site_pos[il] - goal_l) ** 2)
                + 0.01 * jnp.sum(s.qvel**2))

    cfg = MPPIConfig(horizon=20, n_samples=32 if QUICK else 128, n_iters=1,
                     contact=False)
    dt = timed_scan_solves(model, cfg, cost_fn, 3 if QUICK else 10)
    report("dualarm_bimanual_mppi_solves_per_sec", 1.0 / dt, "solves/s")


def torso_ilqr_bench():
    from gym_kmanip_tpu.solvers.ilqr import ILQRConfig, make_ilqr_solver, unflatten_state

    model = get_model("torso")
    s0 = init_state(model)
    xp, xq, _ = kin.fk(model, s0.qpos)
    eer, _ = kin.site_pose(model, xp, xq, "eer_site")
    goal = eer + jnp.asarray([0.0, 0.04, -0.03])

    def cost_xu(x, u):
        s = unflatten_state(model, x, s0)
        xp2, xq2, _ = kin.fk(model, s.qpos)
        ee, _ = kin.site_pose(model, xp2, xq2, "eer_site")
        return (100.0 * jnp.sum((ee - goal) ** 2)
                + 10.0 * jnp.sum((s.cube_pos - s0.cube_pos) ** 2)
                + 0.01 * jnp.sum(s.qvel**2)
                + 1e-3 * jnp.sum((u - s.qpos[: model.nu]) ** 2))

    H = 20 if QUICK else 100
    cfg = ILQRConfig(horizon=H, n_iters=2 if QUICK else 5)
    solver = make_ilqr_solver(model, cfg, cost_xu)
    u0 = jnp.tile(jnp.asarray(model.home_qpos[: model.nu], dtype=jnp.float32), (H, 1))
    res = solver(s0, u0)
    jax.block_until_ready(res.us)
    t0 = time.time()
    res = solver(s0, u0 + 1e-6)  # unique input: defeat the value cache
    jax.block_until_ready(res.us)
    report(f"torso_ilqr_H{H}_solve_time", time.time() - t0, "s")


def vision_bench():
    from gym_kmanip_tpu.mpc.vision_cost import init_cost_params, make_vision_cost
    from gym_kmanip_tpu.mpc.rollout import rollout

    model = get_model("solo_arm")
    params = init_cost_params(jax.random.PRNGKey(0))
    cost_fn = make_vision_cost(model, params)
    s0 = init_state(model)
    H, K = (4, 8) if QUICK else (10, 32)
    useqs = jnp.tile(
        jnp.asarray(model.home_qpos[: model.nu], dtype=jnp.float32), (K, H, 1)
    )

    @jax.jit
    def run(useqs):
        return jax.vmap(lambda u: rollout(model, s0, u, cost_fn)[0])(useqs)

    out = run(useqs)
    jax.block_until_ready(out)
    t0 = time.time()
    out = run(useqs + 1e-6)  # unique input: defeat the value cache
    jax.block_until_ready(out)
    dt = time.time() - t0
    report("vision_mpc_renders_per_sec", H * K / dt, "renders/s")


def vision_closed_loop_bench():
    """Vision-MPC closing the TRUE fingertip-cube distance (VERDICT r1
    item 7): fit the distance CNN from on-device renders, run MPPI whose
    rollouts render the top camera, step the real full-fidelity plant."""
    import numpy as np

    from gym_kmanip_tpu.dynamics.engine import make_control_step
    from gym_kmanip_tpu.mpc.mppi import make_mppi_solver
    from gym_kmanip_tpu.mpc.vision_cost import fit_distance_cost, make_vision_cost

    model = get_model("solo_arm")
    params = fit_distance_cost(
        model, jax.random.PRNGKey(0), n_samples=256, n_steps=1200,
        cam_name="top", height=48, width=64,
    )
    cost_fn = make_vision_cost(
        model, params, cam_name="top", height=48, width=64, w_vel=0.001
    )
    cfg = MPPIConfig(horizon=20, n_samples=32, n_iters=1, sigma=0.12,
                     noise_beta=0.9, contact=False)
    solver = make_mppi_solver(model, cfg, cost_fn)
    ms = init_mppi(model, cfg)
    state = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]))
    q_off = jnp.clip(
        jnp.asarray(model.home_qpos, dtype=jnp.float32).at[0].add(-0.5),
        jnp.asarray(model.jnt_range[:, 0], dtype=jnp.float32),
        jnp.asarray(model.jnt_range[:, 1], dtype=jnp.float32),
    )
    state = state._replace(qpos=q_off, ctrl=q_off[: model.nu])
    ms = ms._replace(nominal=jnp.tile(q_off[: model.nu], (cfg.horizon, 1)))
    plant = make_control_step(model)

    def true_dist(aux, state):
        return float(
            jnp.linalg.norm(aux.tip_pos - state.cube_pos[None, :], axis=-1).min()
        )

    _, aux = plant(state, state.ctrl)
    d0 = true_dist(aux, state)
    d_min = d0
    for _ in range(4 if QUICK else 10):
        ms, u0, J = solver(ms, state)
        state, aux = plant(state, u0)
        d_min = min(d_min, true_dist(aux, state))
    report("vision_mpc_true_dist_reduction", d0 - d_min, "m")
    report("vision_mpc_true_dist_closest", d_min, "m")


def scaling_bench():
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver

    n_dev = len(jax.devices())
    if n_dev < 2:
        report("scaling_efficiency", 1.0, "x (single device; run with a mesh)")
        return
    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    K = 16 * n_dev if QUICK else 64 * n_dev
    H = 10 if QUICK else 30
    times = {}
    for nd in (1, n_dev):
        cfg = MPPIConfig(horizon=H, n_samples=K, n_iters=1)
        mesh = make_mesh(nd)
        solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
        ms, ss = init_mppi(model, cfg), init_state(model)
        out = solver(ms, ss)
        jax.block_until_ready(out[1])
        t0 = time.time()
        for rep in range(3):
            ms_in = ms._replace(rng=jax.random.fold_in(ms.rng, rep + 1))
            out = solver(ms_in, ss)
        jax.block_until_ready(out[1])
        times[nd] = (time.time() - t0) / 3
    eff = times[1] / (times[n_dev] * n_dev)
    report(f"rollout_sharding_efficiency_1_to_{n_dev}dev", eff, "fraction", eff / 0.8)


def vec_env_bench():
    """RL-side throughput headline (VERDICT r2 next #7): env-steps/s of the
    vectorized on-device env — N=1024 state-only and N=256 vision (64x64
    renders, the RL-from-pixels resolution)."""
    from gym_kmanip_tpu.env.vec_env import KManipVecEnv

    for env_id, n_envs, hw, label in (
        ("KManipSoloArmQPos", 64 if QUICK else 1024, None, "state_N{}"),
        ("KManipSoloArmVision", 16 if QUICK else 256, (64, 64), "vision64_N{}"),
    ):
        env = KManipVecEnv(env_id, num_envs=n_envs, seed=0, render_hw=hw)
        obs = env.reset()
        acts = {
            name: jnp.zeros((n_envs, {"eer_pos": 3, "eer_orn": 3, "grip_r": 1,
                                      "q_pos_r": 7}[name]), jnp.float32)
            for name in env.cfg.act_list
        }
        env.step(acts)  # compile
        n = 5 if QUICK else 20
        t0 = time.time()
        for _ in range(n):
            env.step(acts)
        dt = time.time() - t0
        rate = n * n_envs / dt
        # vs the 50 Hz single-env real-time bar
        report(f"vec_env_steps_per_sec_{label.format(n_envs)}", rate,
               "env-steps/s", rate / (50.0 * n_envs))
        env.close()


def bc_bench():
    """data -> train -> eval pick success (VERDICT r2 next #4). Expensive
    (records MPPI-expert episodes); sized down under --quick."""
    import importlib

    mod = importlib.import_module("gym_kmanip_tpu.examples.13_bc_pick")
    kw = (dict(n_episodes=2, ep_len=60, n_samples=64, n_train=800, n_evals=3)
          if QUICK else
          dict(n_episodes=8, ep_len=100, n_samples=256, n_train=3000,
               n_evals=10))
    expert_rate, bc_rate = mod.run_pipeline(log=lambda *a: None, **kw)
    report("mppi_expert_pick_success_rate", expert_rate, "fraction",
           expert_rate)
    report("bc_pick_success_rate", bc_rate, "fraction", bc_rate)


def zoo_bench():
    """Closed-loop success of EVERY shipped policy artifact (no training:
    the artifact is the product — bc_bench above covers the pipeline).
    Each artifact evals on its own morphology over the spawn range
    recorded in its meta (the full CUBE_SPAWN_RANGE for the r5 zoo)."""
    import importlib

    import numpy as np

    from gym_kmanip_tpu import zoo

    bc = importlib.import_module("gym_kmanip_tpu.examples.13_bc_pick")
    for name in zoo.list_policies():
        policy, meta = zoo.load_policy(name)
        spawn_range = meta.get("spawn_range")
        if spawn_range is not None:
            spawn_range = np.asarray(spawn_range, np.float64)
        rate = bc.evaluate(
            policy, n_evals=4 if QUICK else 10,
            ep_len=int(meta.get("eval_ep_len", 120)),
            log=lambda *a: None, model_name=str(meta["model"]),
            spawn_range=spawn_range,
        )
        report(f"zoo_{name}_success_rate", rate, "fraction", rate,
               meta_eval_rate=meta.get("eval_success_rate"))


def pixels_bench():
    """Pick-from-pixels success at a REAL sample size (VERDICT r4 #5:
    the previous evidence was rate>0 over 2 episodes): the examples/14
    estimator+MPC path over >=8 episodes, plus the shipped end-to-end
    pixels-BC artifact if present (zoo_bench evals it too)."""
    import importlib

    mod = importlib.import_module(
        "gym_kmanip_tpu.examples.14_pick_from_pixels")
    n_eps = 4 if QUICK else 8
    rate, est_err = mod.run(n_episodes=n_eps, ep_len=110,
                            log=lambda *a: None)
    report("pixels_pick_success_rate", rate, "fraction", rate,
           episodes=n_eps)
    report("cube_estimator_err_m", est_err, "m", est_err / 0.01)


if __name__ == "__main__":
    mppi_benches()
    dual_arm_bench()
    torso_ilqr_bench()
    vision_bench()
    vision_closed_loop_bench()
    scaling_bench()
    vec_env_bench()
    bc_bench()
    zoo_bench()
    pixels_bench()
