"""Sampling MPC (MPPI) on the cube-pick task -- the flagship closed loop.

No reference analog (gym-kmanip has no MPC; SURVEY.md §2.4): this is the
BASELINE north-star workload. Receding-horizon MPPI with K=256
full-fidelity rollouts per solve (same 10x2 ms integration as the plant),
AR(1)-correlated exploration noise, and a grasp-geometry cost
(fingertip-to-cube distance + touch/lift bonuses). The arm reaches,
touches, and lifts the cube within the 120 control steps; `chip_smoke.py`
runs this loop on the GPU and asserts `lifted=True`.

Shards the sample batch over every local device via the ('rollout',)
mesh when more than one is present.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.dynamics.engine import make_control_step
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver
from gym_kmanip_tpu.utils.compile_cache import enable_compile_cache

HORIZON = 20
N_SAMPLES = 256
N_CONTROL_STEPS = 120
CUBE_SPAWN = np.array([0.15, 0.58, 0.62])


def make_cost(model):
    def cost_fn(s, aux, u):
        # fingertips bracket the cube when grasping: drive their mean
        # squared distance to the cube center, bonus for touch and lift
        d2 = jnp.sum((aux.tip_pos - s.cube_pos[None, :]) ** 2, axis=-1)
        touched = aux.touch_r | aux.touch_l
        return (
            50.0 * jnp.mean(d2)
            + 0.01 * jnp.sum(s.qvel**2)
            - jnp.where(touched, 5.0, 0.0)
            - jnp.where(touched & ~aux.touch_table, 10.0, 0.0)
        )

    return cost_fn


def make_config(horizon=HORIZON, n_samples=N_SAMPLES):
    # full-fidelity rollouts: contact at 20 ms substeps is numerically
    # explosive (dt*sqrt(k/m) ~ 9), so the rollouts integrate at 10x2 ms
    return MPPIConfig(
        horizon=horizon, n_samples=n_samples, n_iters=2, sigma=0.15,
        n_substeps=10, dt=k.PHYSICS_TIMESTEP, noise_beta=0.9,
    )


def closed_loop(solver, plant_step, mppi_state, sim_state, n_steps,
                log_every=15):
    """Receding-horizon loop: one solve, then one plant control step.

    Returns (sim_state, touch_steps, lifted, solve_seconds), where
    solve_seconds holds the wall time of each solve, ended by
    `block_until_ready` on its control."""
    touch_steps, lifted, solve_s = 0, False, []
    for i in range(n_steps):
        t0 = time.perf_counter()
        mppi_state, u0, J = solver(mppi_state, sim_state)
        jax.block_until_ready(u0)
        solve_s.append(time.perf_counter() - t0)
        sim_state, aux = plant_step(sim_state, u0)
        touch_steps += int(bool(aux.touch_r))
        lifted = lifted or (bool(aux.touch_r) and not bool(aux.touch_table))
        if log_every and i % log_every == 0:
            dmin = float(
                jnp.linalg.norm(aux.tip_pos - sim_state.cube_pos[None, :], axis=-1).min()
            )
            print(
                f"step {i}: J={float(J):.2f} tip-cube dist={dmin:.3f} m "
                f"touch={bool(aux.touch_r)} cube_z={float(sim_state.cube_pos[2]):.3f}"
            )
    return sim_state, touch_steps, lifted, solve_s


def main():
    enable_compile_cache()
    model = get_model("solo_arm")
    cost_fn = make_cost(model)
    cfg = make_config()
    if len(jax.devices()) > 1:
        mesh = make_mesh()
        print(f"sharding {N_SAMPLES} rollouts over {mesh.devices.size} devices")
        solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
    else:
        solver = make_mppi_solver(model, cfg, cost_fn)

    plant_step = make_control_step(model)
    mppi_state = init_mppi(model, cfg)
    sim_state = init_state(model, cube_pos=CUBE_SPAWN)

    mppi_state, u0, _ = solver(mppi_state, sim_state)  # compile
    jax.block_until_ready(u0)

    t0 = time.time()
    _, touch_steps, lifted, _ = closed_loop(
        solver, plant_step, mppi_state, sim_state, N_CONTROL_STEPS
    )
    wall = time.time() - t0
    print(
        f"{N_CONTROL_STEPS} MPC solves + plant steps in {wall:.2f}s "
        f"({N_CONTROL_STEPS / wall:.1f} Hz closed loop); "
        f"touch steps={touch_steps}, lifted={lifted}"
    )


if __name__ == "__main__":
    main()
