"""True multi-host (multi-process) loopback test on CPU.

VERDICT r1 item 2i: `parallel/mesh.py` claims multi-host support through
`jax.distributed.initialize`, so exercise the REAL multi-process code path —
two OS processes, a coordinator service on localhost (DCN-style), a global
mesh spanning both processes' devices, and cross-process collectives
(psum/pmin + the deterministic `global_elite` selection) over it. This is
the standard fake-multihost pattern (SURVEY.md §4) one level deeper than
the 8-virtual-device tests: here every collective actually crosses a
process boundary.
"""

import os
import socket
import subprocess
import sys

_CHILD = r"""
import os, sys
pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
# cross-process CPU collectives need the gloo transport (the default CPU
# client is not cluster-aware and would leave process_count() == 1)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=n, process_id=pid
)
assert jax.process_count() == n, jax.process_count()
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental import multihost_utils

from gym_kmanip_tpu.parallel.mesh import global_elite

devs = np.array(jax.devices())  # 2 per process -> 4 global
assert devs.size == 2 * n, devs
mesh = Mesh(devs, ("rollout",))
local_k = 3
K = devs.size * local_k

# every process holds the full host value; shard it onto the global mesh
costs_h = np.ones(K, dtype=np.float32)
cand_h = np.arange(K * 4, dtype=np.float32).reshape(K, 4)
win = 1 * local_k + 1          # a device on process 0
costs_h[win] = 0.5
costs_h[(devs.size - 1) * local_k] = 0.5   # tie on the last device (proc 1)

costs = multihost_utils.host_local_array_to_global_array(
    costs_h.reshape(n, -1)[pid], mesh, P("rollout")
)
cand = multihost_utils.host_local_array_to_global_array(
    cand_h.reshape(n, -1, 4)[pid], mesh, P("rollout")
)

f = jax.jit(
    jax.shard_map(
        lambda c, x: (
            global_elite(c, x, local_k)
            + (jax.lax.psum(jnp.sum(c), "rollout"),)
        ),
        mesh=mesh,
        in_specs=(P("rollout"), P("rollout")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
)
best, gmin, total = f(costs, cand)
# P() outputs are replicated: every process holds the full value in its
# local shard
best = np.asarray(best.addressable_data(0))
gmin = float(np.asarray(gmin.addressable_data(0)))
total = float(np.asarray(total.addressable_data(0)))
assert gmin == 0.5, gmin
assert total == float(costs_h.sum()), (total, costs_h.sum())
np.testing.assert_array_equal(np.asarray(best), cand_h[win])
print(f"MULTIHOST_OK pid={pid} procs={jax.process_count()} gdev={devs.size}")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_loopback(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # the children run on the CPU, whatever platform this process has
    inherited = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + inherited)
    env.pop("JAX_PLATFORM_NAME", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert "MULTIHOST_OK" in out, out
