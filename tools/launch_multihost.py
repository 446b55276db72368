"""Single-command multi-host scaling harness (VERDICT r2 next #10).

The BASELINE "≥80% scaling efficiency to 2+ hosts" row needs real pod
hardware, which this environment does not have. This tool makes that
measurement a ONE-COMMAND affair the day it does, and provides two
hardware-free validations of the same code path in the meantime:

Real pod (run the same command on every host; host 0 is the coordinator):

    python tools/launch_multihost.py --num-processes 2 \
        --coordinator <host0-ip>:8476 --process-id <0|1> [--K 512 --H 50]

  Each process calls `parallel.mesh.init_distributed`, builds ONE global
  ('rollout',) mesh over all chips, runs the sharded MPPI solver
  (shard_map fan-out; only scalars + the (H, nu) update cross hosts over
  DCN), and process 0 reports solves/s, solves/s/chip, and — when
  --baseline-per-chip (the recorded 1-host number) is given — the scaling
  efficiency against the ≥0.8 bar.

Local 2-process loopback (no hardware; the tests/test_multihost.py
pattern — every collective really crosses an OS process boundary):

    python tools/launch_multihost.py --local-spawn 2

Weak-scaling proxy on the 8-virtual-device CPU mesh (single process):

    python tools/launch_multihost.py --proxy

  Re-execs itself under JAX_PLATFORMS=cpu with 8 virtual devices and
  prints the 1->2->4->8 weak-scaling curve of the sharded solver. CPU
  absolute numbers say nothing of the GPU (XLA:CPU has a vmap pathology
  on the substep); the CURVE isolates the sharding/collective overhead,
  which is what transfers.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _report(metric, value, unit, vs=None):
    line = {"metric": metric, "value": round(float(value), 4), "unit": unit}
    if vs is not None:
        line["vs_baseline"] = round(float(vs), 3)
    print(json.dumps(line), flush=True)


def _bench_global_mesh(K_per_dev: int, H: int, n_iters: int, n_reps: int = 5):
    """Sharded-MPPI weak-scaling measurement over ALL global devices.
    Returns (solves/s, n_global_devices)."""
    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver

    n_dev = len(jax.devices())
    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    cfg = MPPIConfig(horizon=H, n_samples=K_per_dev * n_dev, n_iters=n_iters)
    mesh = make_mesh(n_dev)
    solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
    ms, ss = init_mppi(model, cfg), init_state(model)
    out = solver(ms, ss)  # compile
    jax.block_until_ready(out[1])
    t0 = time.time()
    for _ in range(n_reps):
        out = solver(ms, ss)
    jax.block_until_ready(out[1])
    return n_reps / (time.time() - t0), n_dev


def run_distributed(args):
    from gym_kmanip_tpu.parallel.mesh import init_distributed

    import jax

    init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes
    rate, n_dev = _bench_global_mesh(args.K, args.H, args.n_iters)
    if jax.process_index() == 0:
        per_chip = rate * n_dev / n_dev  # solves are global; chips share one solve
        _report(f"multihost_mppi_solves_per_sec_{args.num_processes}proc",
                rate, "solves/s")
        _report("multihost_global_devices", n_dev, "devices")
        if args.baseline_per_chip:
            # weak scaling: each chip carries K_per_dev samples either way,
            # so efficiency = (N-host solves/s) / (1-host solves/s)
            eff = rate / args.baseline_per_chip
            _report("multihost_scaling_efficiency", eff, "fraction", eff / 0.8)


_CHILD_ENV_NOTE = """Local-spawn child: CPU gloo collectives, 2 virtual
devices per process — the exact init path a multi-host run takes, minus
the interconnect."""


def run_local_spawn(n: int):
    """Spawn n loopback processes running THIS script's distributed path."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(n):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            JAX_CPU_COLLECTIVES_IMPLEMENTATION="gloo",
            PYTHONPATH=os.pathsep.join(
                [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
                + os.environ.get("PYTHONPATH", "").split(os.pathsep)
            ),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--num-processes", str(n), "--process-id", str(pid),
                 "--coordinator", f"127.0.0.1:{port}",
                 "--K", "8", "--H", "5", "--n-iters", "1"],
                env=env,
                stdout=subprocess.PIPE if pid > 0 else None,
                stderr=subprocess.STDOUT if pid > 0 else None,
            )
        )
    rcs = [p.wait(timeout=600) for p in procs]
    assert all(rc == 0 for rc in rcs), f"child rcs: {rcs}"
    print(f"local {n}-process loopback: OK (gloo collectives crossed "
          f"process boundaries)")


def run_proxy():
    """Weak-scaling curve on the 8-virtual-device CPU mesh."""
    if os.environ.get("_KMANIP_PROXY_CHILD") != "1":
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            _KMANIP_PROXY_CHILD="1",
        )
        sys.exit(
            subprocess.call(
                [sys.executable, os.path.abspath(__file__), "--proxy"], env=env
            )
        )
    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver

    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    K_PER_DEV, H = 8, 10
    t1 = None
    for nd in (1, 2, 4, 8):
        cfg = MPPIConfig(horizon=H, n_samples=K_PER_DEV * nd, n_iters=1)
        mesh = make_mesh(nd)
        solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
        ms, ss = init_mppi(model, cfg), init_state(model)
        out = solver(ms, ss)
        jax.block_until_ready(out[1])
        t0 = time.time()
        for _ in range(5):
            out = solver(ms, ss)
        jax.block_until_ready(out[1])
        dt = (time.time() - t0) / 5
        if nd == 1:
            t1 = dt
        # weak scaling: per-device work constant, ideal time flat
        eff = t1 / dt
        _report(f"weak_scaling_proxy_{nd}dev", eff, "fraction",
                eff / 0.8 if nd > 1 else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default="127.0.0.1:8476")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--K", dest="K", type=int, default=256,
                    help="samples PER DEVICE (weak scaling)")
    ap.add_argument("--H", dest="H", type=int, default=50)
    ap.add_argument("--n-iters", type=int, default=1)
    ap.add_argument("--baseline-per-chip", type=float, default=None,
                    help="1-host solves/s for the efficiency row")
    ap.add_argument("--local-spawn", type=int, default=None,
                    help="spawn N loopback processes on this machine")
    ap.add_argument("--proxy", action="store_true",
                    help="8-virtual-device CPU weak-scaling curve")
    args = ap.parse_args()

    if args.proxy:
        run_proxy()
    elif args.local_spawn:
        run_local_spawn(args.local_spawn)
    else:
        assert args.num_processes is not None and args.process_id is not None
        run_distributed(args)


if __name__ == "__main__":
    main()
