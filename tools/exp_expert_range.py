"""MPPI pick-expert success over the FULL CUBE_SPAWN_RANGE (on the GPU).

The zoo's BC ceiling is the expert's own competence; before scaling the
spawn box (VERDICT r4 #4) this measures where the examples/13 expert
actually succeeds across the reference's 20x20 cm spawn area.

Run: python tools/exp_expert_range.py [n_episodes] [ep_len]
"""

import importlib
import sys
import time

sys.path.insert(0, "/root/repo")

import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.dynamics.engine import make_control_step
from gym_kmanip_tpu.models import get_model

bc = importlib.import_module("gym_kmanip_tpu.examples.13_bc_pick")


def main(n_episodes=12, ep_len=120, seed=0):
    model = get_model("solo_arm")
    solver, mppi0 = bc.make_expert(model)
    plant_step = make_control_step(model)
    rng = np.random.RandomState(seed)
    wins, results = 0, []
    for ep in range(n_episodes):
        spawn = rng.uniform(k.CUBE_SPAWN_RANGE[:, 0], k.CUBE_SPAWN_RANGE[:, 1])
        state = init_state(model, cube_pos=spawn)
        ms = mppi0
        lifted = False
        t0 = time.time()
        # let the cube settle from its (possibly airborne) z spawn before
        # judging the lift height
        for _ in range(5):
            state, _ = plant_step(state, jnp.asarray(
                model.home_qpos[: model.nu], jnp.float32))
        z0 = float(state.cube_pos[2])
        for t in range(ep_len):
            ms, u0, J = solver(ms, state)
            state, aux = plant_step(state, u0)
            lifted = lifted or float(state.cube_pos[2]) > z0 + bc.LIFT_DZ
        wins += int(lifted)
        results.append((spawn.round(3).tolist(), lifted))
        print(f"ep {ep}: spawn {spawn.round(3)} lifted={lifted} "
              f"({time.time()-t0:.1f}s)", flush=True)
    print(f"expert full-range success: {wins}/{n_episodes}")
    for r in results:
        print(r)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    el = int(sys.argv[2]) if len(sys.argv) > 2 else 120
    main(n, el)
