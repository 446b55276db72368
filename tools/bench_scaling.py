"""Rollout-sharding efficiency on the virtual CPU mesh — one JSON line.

Strong scaling of the sharded MPPI solve (fixed total K, 1 device vs 8
virtual CPU devices), the same formula as tools/bench_suite.scaling_bench:

    eff = t(1 dev) / (t(n dev) * n)

Run by bench.py in a subprocess (JAX_PLATFORMS=cpu + 8 virtual devices)
so the driver-captured artifact records a scaling-efficiency number every
round (VERDICT r4 #3). This is a PROXY: 8 virtual devices share this
host's physical cores, so the ceiling is set by the core count, not the
interconnect —
the row exists to track regressions in the sharding machinery, while the
>=80% BASELINE bar belongs to real multi-chip hardware
(tools/launch_multihost.py).
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver

    n_dev = len(jax.devices())
    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    K, H = 16 * n_dev, 10
    times = {}
    for nd in (1, n_dev):
        cfg = MPPIConfig(horizon=H, n_samples=K, n_iters=1)
        mesh = make_mesh(nd)
        solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
        ms, ss = init_mppi(model, cfg), init_state(model)
        out = solver(ms, ss)
        np.asarray(out[1])
        t0 = time.time()
        for rep in range(3):
            ms_in = ms._replace(rng=jax.random.fold_in(ms.rng, rep + 1))
            out = solver(ms_in, ss)
        np.asarray(out[1])
        times[nd] = (time.time() - t0) / 3
    eff = times[1] / (times[n_dev] * n_dev)
    print(json.dumps({
        "efficiency": round(float(eff), 4),
        "n_dev": n_dev,
        "t1_ms": round(times[1] * 1e3, 2),
        "tn_ms": round(times[n_dev] * 1e3, 2),
    }))


if __name__ == "__main__":
    main()
