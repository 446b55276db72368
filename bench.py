"""Headline benchmarks on one NVIDIA GPU. Prints one JSON line per metric
({"metric", "value", "unit", "vs_baseline", "device", "card", ...}); the
HEADLINE metric (open-loop MPPI solves/s at H=50 K=256) is printed LAST.

Every line names the device it ran on: `device` is JAX's device_kind and
`card` is nvidia-smi's name and power limit. Rows measured by a child
process on the host CPU say `"platform": "cpu"`. The device must be in
PEAKS, the table of published peaks the roofline rows divide by; any other
device is an error, not a default. Each metric runs under its own
try/except so one failure cannot hide the others, and the process exits
nonzero if any metric failed. Times end in `block_until_ready`; each rate
is the median over repeats, with compilation done before the timed window.

Metrics:
  * ilqr_solves_per_sec_torso_H100_10iter — fused single-dispatch iLQR,
    production config (reduced state, Gauss-Newton cost, one-sided FD);
    plus the solo H=50 row and the full-state torso row.
  * rollout_sharding_efficiency — strong scaling of the sharded MPPI solve
    over 8 virtual CPU devices (a host-CPU proxy for the sharding
    machinery, tools/bench_scaling.py).
  * closed_loop_mpc_hz_H20_K256_fullfidelity — receding-horizon rate with
    the plant advanced by the env's full-fidelity 10x2 ms contact step
    between solves (examples/8_mpc_mppi.py), vs the 50 Hz control bar.
  * mppi_solves_per_sec_chip_H100_K256 — BASELINE.md's long-horizon row.
  * substep_flops / substep_mfu_pct / substep_hbm_roofline_pct /
    substep_wall_ns — analytic FLOPs and compulsory bytes of one substep
    (XLA cost analysis) against the device's published f32 and memory
    peaks, at the rate the H=50 row measured.
  * gym_env_step_hz_solo_cpu — single-env Gym step, ours vs the reference,
    on the host CPU (tools/bench_env_step.py in a JAX_PLATFORMS=cpu child).
  * gym_env_step_hz_solo_device — the same env.step on the GPU backend.
  * mppi_solves_per_sec_chip_H50_K256 — headline (north star: >50/s).

The reference publishes no benchmarks (BASELINE.md); vs_baseline uses the
north-star bars noted per metric.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_SAMPLES = 256
# Solves per timed program for the open-loop throughput rows: one scanned
# program of N_SOLVES solves measures steady-state solve throughput without
# a host dispatch per solve.
N_SOLVES = 200
REPS = 5

# device_kind -> (f32 peak FLOP/s outside the tensor cores, memory bytes/s),
# from NVIDIA's H100 data sheet (dense rates). The substep's f32
# elementwise work never reaches the tensor cores, so the f32 figure is
# its compute roof.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": (51e12, 2.0e12),
}

DEVICE = {}  # filled by main(): tags every emitted line
FAILED = []


def _emit(metric, value, unit, vs, **extra):
    line = {"metric": metric, "value": float(value), "unit": unit,
            "vs_baseline": float(vs), **DEVICE}
    line.update(extra)
    print(json.dumps(line), flush=True)


def _emit_error(stage, exc):
    FAILED.append(stage)
    traceback.print_exc(file=sys.stderr)
    print(json.dumps({"metric": f"bench_error[{stage}]", "value": 0.0,
                      "unit": "error", "vs_baseline": 0.0, **DEVICE,
                      "error": f"{type(exc).__name__}: {exc}"}), flush=True)


def peaks(kind):
    """(f32 FLOP/s, bytes/s) of a device kind; unknown kinds raise."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}; add it to PEAKS")
    return PEAKS[kind]


def _median_seconds(fn, *args):
    import jax

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def open_loop(model, cost_fn, horizon):
    """Steady-state MPPI throughput: one compiled program of N_SOLVES
    chained solves, timed end to end."""
    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi, mppi_solve

    cfg = MPPIConfig(horizon=horizon, n_samples=N_SAMPLES, n_iters=1, n_substeps=1)
    mppi_state = init_mppi(model, cfg)
    sim_state = init_state(model)

    @jax.jit
    def run_solves(mppi_state, sim_state):
        def body(ms, _):
            ms2, u0, J = mppi_solve(model, cfg, ms, sim_state, cost_fn)
            return ms2, J

        return jax.lax.scan(body, mppi_state, None, length=N_SOLVES)

    jax.block_until_ready(run_solves(mppi_state, sim_state))  # compile
    return N_SOLVES / _median_seconds(run_solves, mppi_state, sim_state)


def closed_loop(model):
    """Receding-horizon MPC with the plant advanced by the full-fidelity
    env step between solves (examples/8_mpc_mppi.py recipe)."""
    import importlib

    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.dynamics.engine import make_control_step
    from gym_kmanip_tpu.mpc.mppi import init_mppi, make_mppi_solver

    ex = importlib.import_module("gym_kmanip_tpu.examples.8_mpc_mppi")
    cfg = ex.make_config(n_samples=N_SAMPLES)
    solver = make_mppi_solver(model, cfg, ex.make_cost(model))
    plant_step = make_control_step(model)
    mppi_state = init_mppi(model, cfg)
    sim_state = init_state(model, cube_pos=ex.CUBE_SPAWN)

    mppi_state, u0, J = solver(mppi_state, sim_state)  # compile
    jax.block_until_ready(plant_step(sim_state, u0))

    n = 30
    t0 = time.perf_counter()
    for _ in range(n):
        mppi_state, u0, J = solver(mppi_state, sim_state)
        sim_state, aux = plant_step(sim_state, u0)
    jax.block_until_ready(sim_state)
    return n / (time.perf_counter() - t0)


def substep_cost(model):
    """(flops, min_hbm_bytes) of ONE dynamics substep.

    flops: XLA cost analysis of the substep. min_hbm_bytes: COMPULSORY
    traffic — the state pytree read + written once per substep, the
    roofline denominator a streaming deployment would pay."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu import constants as k
    from gym_kmanip_tpu.dynamics import engine, init_state

    state = init_state(model)
    state = state._replace(
        ctrl=jnp.asarray(model.home_qpos[: model.nu], dtype=jnp.float32)
    )

    def one(state):
        new, _ = engine.substep(model, state, k.PHYSICS_TIMESTEP)
        return new

    an = jax.jit(one).lower(state).compile().cost_analysis()
    if isinstance(an, list):
        an = an[0]
    state_bytes = sum(
        leaf.size * leaf.dtype.itemsize for leaf in jax.tree.leaves(state)
    )
    return float(an.get("flops", 0.0)), float(2 * state_bytes)


def ilqr_rate(model_name="torso", horizon=100, production=True):
    """Fused single-dispatch iLQR (n_iters=10): solves/s vs the 50 Hz
    real-time bar.

    production=True is the deployment configuration: reduced_state
    (contact=False decouples the cube, so the solver state is [qpos,
    qvel]) with the Gauss-Newton cost quadratization
    (mpc.cost.make_ee_tracking_cost_ilqr) and one-sided FD probes.
    production=False is the full 2nq+13 state with the exact
    autodiff-Hessian quadratization and centered differences."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import make_ee_tracking_cost_ilqr
    from gym_kmanip_tpu.ops import kinematics as kin
    from gym_kmanip_tpu.solvers.ilqr import ILQRConfig, make_ilqr_solver

    model = get_model(model_name)
    state0 = init_state(model)
    xp, xq, _ = kin.fk(model, state0.qpos)
    p, _ = kin.site_pose(model, xp, xq, "eer_site")
    goal = np.asarray(p) + np.array([0.0, 0.05, -0.05], np.float32)

    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(
        model, goal, w_pos=50.0, w_vel=0.01, w_ctrl=0.001
    )

    H = horizon
    if production:
        cfg = ILQRConfig(horizon=H, n_iters=10, contact=False,
                         reduced_state=True)
        solve = make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu)
    else:
        cfg = ILQRConfig(horizon=H, n_iters=10, contact=False, fd_order=2)
        solve = make_ilqr_solver(model, cfg, cost_xu)
    us = jnp.tile(
        jnp.asarray(model.home_qpos[: model.nu], dtype=jnp.float32), (H, 1)
    )
    r = jax.block_until_ready(solve(state0, us))  # compile
    rate = 1.0 / _median_seconds(solve, state0, us)
    return rate, np.asarray(r.cost_trace)


def ilqr_solve_flops(model_name="torso", horizon=100, n_iters=10):
    """Analytic FLOPs of ONE complete fused production iLQR solve
    (reduced_state + GN quadratization + fd_order=1), the numerator of
    the whole-solve MFU row.

    Counted: every dynamics evaluation (FD probes + 6-alpha line search
    + nominal rollout) at the XLA-cost-analysis FLOPs of one substep;
    the GN cost quadratization (XLA cost analysis of the exact vmapped
    program); and the Riccati sweep's per-step GEMM/solve arithmetic.
    Uncounted (small): clips, argmin, bookkeeping — so this is a slight
    lower bound and the MFU a slight underestimate."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import make_ee_tracking_cost_ilqr
    from gym_kmanip_tpu.ops import kinematics as kin

    model = get_model(model_name)
    sf, _ = substep_cost(model)
    nq, nu = model.nq, model.nu
    n, m = 2 * nq, nu
    z = n + m

    state0 = init_state(model)
    xp, xq, _ = kin.fk(model, state0.qpos)
    p, _ = kin.site_pose(model, xp, xq, "eer_site")
    _cost, quad_xu = make_ee_tracking_cost_ilqr(model, np.asarray(p))
    X = jnp.zeros((horizon, n), jnp.float32)
    U = jnp.zeros((horizon, nu), jnp.float32)
    an = jax.jit(jax.vmap(quad_xu)).lower(X, U).compile().cost_analysis()
    if isinstance(an, list):
        an = an[0]
    quad_fl = float(an.get("flops", 0.0))

    # Riccati sweep per step (ilqr.riccati_sweep): A'Vx, B'Vx, A'VxxA,
    # B'VxxB, B'VxxA, the m x m solve against [Qu | Qux], and the value
    # update's gain products
    per_step = (
        2 * z * n * (1 + n)
        + 2 * z * n * z
        + 2 * m * m * (1 + n)
        + 2 * 2 * (1 + n) * m * (1 + n)
        + m**3 / 3.0
        + 2 * m * m * (1 + n)
    )
    sweep_fl = horizon * per_step

    # dynamics evaluations: fd_order=1 probes (z per step) + 6-alpha line
    # search + the nominal rollout
    evals = n_iters * (horizon * z + 6 * horizon) + horizon
    return evals * sf + n_iters * (sweep_fl + quad_fl)


def _cpu_child(script, *args):
    """Last JSON line of a tool run in a JAX_PLATFORMS=cpu child, so that
    it never opens the card this process holds."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", script), *args],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    for line in reversed(proc.stdout.strip().splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON from {script} rc={proc.returncode}: "
                       f"{proc.stderr[-500:]}")


def gym_env_rate_device(n_steps=50):
    """End-user Gym env.step rate on the GPU backend: gym.make(...).step()
    with the split pipeline goals-jit -> native host IK -> core-jit,
    which syncs with the device twice per step."""
    import gymnasium as gym

    import gym_kmanip_tpu  # noqa: F401  (registers env ids)

    env = gym.make("KManipSoloArm")
    env.reset(seed=0)
    rng = np.random.RandomState(3)

    def act():
        return {
            "eer_pos": rng.uniform(-1, 1, 3).astype(np.float32),
            "eer_orn": np.zeros(3, dtype=np.float32),
            "grip_r": np.zeros(1, dtype=np.float32),
        }

    for _ in range(5):
        env.step(act())
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            env.step(act())
        rates.append(n_steps / (time.perf_counter() - t0))
    env.close()
    return float(np.median(rates))


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def main():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: JAX backend is {jax.default_backend()!r}, not 'gpu'")
    kind = jax.devices()[0].device_kind
    peak_flops, peak_bw = peaks(kind)
    DEVICE.update(device=kind, card=_card(), platform="gpu")

    sys.path.insert(0, REPO)
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=10)
    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    has_gym = importlib.util.find_spec("gymnasium") is not None

    if os.environ.get("BENCH_ILQR", "1") != "0":
        try:
            rate, trace = ilqr_rate("torso", 100)
            _emit("ilqr_solves_per_sec_torso_H100_10iter", rate, "solves/s",
                  rate / 50.0, config="reduced_state+gn_quad+fd1",
                  trace_first=float(trace[0]), trace_last=float(trace[-1]))
            # whole-solve MFU: analytic FLOPs of the complete 10-iteration
            # program vs measured wall
            fl_solve = ilqr_solve_flops("torso", 100)
            mfu = 100.0 * fl_solve * rate / peak_flops
            _emit("ilqr_solve_mfu_pct_f32peak", mfu, "%", mfu / 100.0,
                  flops_analytic_per_solve=fl_solve)
        except Exception as e:  # noqa: BLE001 — one row must not sink the rest
            _emit_error("ilqr_torso", e)
        try:
            rate, trace = ilqr_rate("solo_arm", 50)
            _emit("ilqr_solves_per_sec_solo_H50_10iter", rate, "solves/s",
                  rate / 50.0, config="reduced_state+gn_quad+fd1",
                  trace_first=float(trace[0]), trace_last=float(trace[-1]))
        except Exception as e:  # noqa: BLE001
            _emit_error("ilqr_solo", e)
        try:
            # full 2nq+13 state, exact autodiff Hessians, centered FD: keeps
            # config changes apart from speedups of the shared code
            rate, _tr = ilqr_rate("torso", 100, production=False)
            _emit("ilqr_solves_per_sec_torso_H100_10iter_fullstate", rate,
                  "solves/s", rate / 50.0, config="fullstate+hessian+fd2")
        except Exception as e:  # noqa: BLE001
            _emit_error("ilqr_torso_fullstate", e)

    try:
        row = _cpu_child("bench_scaling.py")
        _emit(f"rollout_sharding_efficiency_1_to_{row['n_dev']}dev",
              row["efficiency"], "fraction", row["efficiency"] / 0.8,
              platform="cpu", mesh="virtual_cpu_8dev_proxy",
              t1_ms=row["t1_ms"], tn_ms=row["tn_ms"])
    except Exception as e:  # noqa: BLE001
        _emit_error("scaling_efficiency", e)

    try:
        cl_hz = closed_loop(model)
        _emit("closed_loop_mpc_hz_H20_K256_fullfidelity", cl_hz, "Hz",
              cl_hz / 50.0)
    except Exception as e:  # noqa: BLE001
        _emit_error("closed_loop", e)

    try:
        s100 = open_loop(model, cost_fn, 100)
        _emit("mppi_solves_per_sec_chip_H100_K256", s100, "solves/s",
              s100 / 50.0)
    except Exception as e:  # noqa: BLE001
        _emit_error("open_loop_H100", e)

    s50 = 0.0
    try:
        s50 = open_loop(model, cost_fn, 50)
    except Exception as e:  # noqa: BLE001
        _emit_error("open_loop_H50", e)

    try:
        fl, hbm_bytes = substep_cost(model)
        if fl > 0 and s50 > 0:
            substep_rate = s50 * N_SAMPLES * 50  # substeps/s from H=50 bench
            mfu = 100.0 * fl * substep_rate / peak_flops
            _emit("substep_flops_analytic", fl, "flops", fl / 1e6)
            _emit("substep_mfu_pct_f32peak", mfu, "%", mfu / 100.0)
            # compulsory-traffic roofline: the rate if every substep
            # streamed its state in and out at peak memory bandwidth
            roofline_rate = peak_bw / hbm_bytes
            pct = 100.0 * substep_rate / roofline_rate
            _emit("substep_min_hbm_bytes", hbm_bytes, "bytes", hbm_bytes / 1e3)
            _emit("substep_hbm_roofline_pct", pct, "%", pct / 100.0)
            _emit("substep_wall_ns", 1e9 / substep_rate, "ns",
                  substep_rate / 1e6)
            # whole-solve MFU for the headline MPPI program: K x H substep
            # evaluations per solve (cost/weighting terms uncounted ->
            # slight lower bound)
            mppi_fl = N_SAMPLES * 50 * fl
            mfu_solve = 100.0 * mppi_fl * s50 / peak_flops
            _emit("mppi_solve_mfu_pct_f32peak", mfu_solve, "%",
                  mfu_solve / 100.0, flops_analytic_per_solve=mppi_fl)
    except Exception as e:  # noqa: BLE001
        _emit_error("substep_roofline", e)

    if has_gym:
        try:
            env_hz = _cpu_child("bench_env_step.py")
            _emit("gym_env_step_hz_solo_cpu", env_hz["ours_hz"], "Hz",
                  env_hz.get("speedup") or 0.0, platform="cpu",
                  reference_hz=env_hz.get("reference_hz"),
                  native_ik=env_hz.get("native_ik"))
        except Exception as e:  # noqa: BLE001
            _emit_error("gym_env_rate_cpu", e)
        try:
            dev_hz = gym_env_rate_device()
            _emit("gym_env_step_hz_solo_device", dev_hz, "Hz", dev_hz / 50.0)
        except Exception as e:  # noqa: BLE001
            _emit_error("gym_env_rate_device", e)
    else:
        print(json.dumps({"metric": "gym_env_step_hz_solo", **DEVICE,
                          "skipped": "gymnasium is not installed"}), flush=True)

    _emit(f"mppi_solves_per_sec_chip_H50_K{N_SAMPLES}", s50, "solves/s",
          s50 / 50.0)
    if FAILED:
        raise SystemExit(f"bench: {len(FAILED)} metric(s) failed: {FAILED}")


if __name__ == "__main__":
    main()
