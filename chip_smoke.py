"""Bring-up check of the engine on an NVIDIA GPU.

    python chip_smoke.py          # one card: the four phases below
    python chip_smoke.py --four   # four cards: the sharded paths only

One process drives the card; no child process opens JAX. The phases:

1. device: refuse to run unless JAX's backend is the GPU (no CPU
   fallback, nothing in interpret mode); print the card, its power limit
   and any XLA_FLAGS.
2. dynamics: `vmap(substep)` at K=256 with contact for solo_arm, dual_arm
   and torso, at 2 ms explicit and 20 ms implicit, against the host CPU;
   then the MuJoCo golden trace replayed on the card against its 1e-3 rad
   bound.
3. flagship MPPI: examples/8_mpc_mppi.py's closed loop (K=256, H=20,
   10x2 ms substeps, 120 control steps) must lift the cube; the first
   solve is replayed from its own key, its cost and control must be the
   replay's elite, and the replay's rollout costs must match the CPU.
4. iLQR: the production torso solve (H=100, 10 iterations, reduced state,
   Gauss-Newton cost, one-sided FD) must descend, and its cost after the
   first iteration must match the same solve on the CPU.

`--four` runs the sharded MPPI solve (K=1024, 256 per card) and the
sharded iLQR fleet (B=16) over `make_mesh(4)`, each against the same work
on one card, and prints each card's peak memory.

Each phase first registers its calls (a public entry point and its
arguments); all of them run once together in a thread pool (XLA compiles
one module on one core, and a cold run is mostly compilation), so each
program is compiled once, by its first call, and the phases' checks get
those first results. The CPU references of batched work run one item per
call: XLA:CPU runs these unrolled graphs about fifty times slower per item
under vmap.

Any failure raises, so the exit code is nonzero and no result line is
printed. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "solo_arm_dynamics.npz")

ROBOTS = ("solo_arm", "dual_arm", "torso")
# (dt, implicit_actuation): the env plant's 2 ms explicit servos and the
# coarse 20 ms stable-PD regime
REGIMES = ((0.002, False), (0.02, True))
# GPU vs CPU, both float32 at HIGHEST matmul precision. Each is within
# (atol 1e-5 on positions, 1e-4 on velocities; rtol 1e-4) of a float64
# evaluation of the same code (tests/test_precision.py); two such
# evaluations differ by at most twice that.
DYN_TOL = {"qpos": 2e-5, "cube_pos": 2e-5, "qvel": 2e-4, "cube_linvel": 2e-4,
           "cube_angvel": 2e-4, "cube_quat": 2e-5}
DYN_RTOL = 2e-4
GOLDEN_BOUND = 1e-3  # rad, the north-star control deviation vs MuJoCo
# MPPI rollout costs: 200 explicit 2 ms substeps compound the f32
# differences of two compilations; costs are sums of O(1) terms.
COST_RTOL = 1e-3
# The MPPI solver against its own replay on the same card: one program
# against another, both float32 at HIGHEST; the elite is the same
# candidate, its cost a sum whose order the two compilations may change.
REPLAY_RTOL = 1e-4
# iLQR cost after the first iteration, card against CPU: the FD
# linearization divides float32 state differences by its 1e-3 step, so the
# two compilations' rounding reaches the gains (measured 3.1e-4 relative on
# the torso at H=100 on an H100). Each later iteration starts from the
# previous gap and widens it (1.2e-3 after the second), so later entries
# are checked only for descent.
ILQR_RTOL = 1e-3
GOAL_OFFSET = (0.0, 0.05, -0.05)  # m, from the home end-effector site (bench.py)


def log(msg):
    print(msg, flush=True)


def card_lines():
    """nvidia-smi's name and power limit for each card, read by a child
    that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def check_device(n_cards):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}")
    log(f"device: {devs[0].device_kind} x{len(devs)} ({backend})")
    for line in card_lines():
        log(f"nvidia-smi: {line}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _on(device, fn, *args):
    """Run `fn` with `device` as JAX's default device (None: unchanged)."""
    import contextlib

    import jax

    with jax.default_device(device) if device is not None else contextlib.nullcontext():
        return fn(*args)


def first_calls(jobs):
    """Make each job's first call, all concurrently, and return their
    results by label. A job is (label, fn, args, device): `fn(*args)` with
    `device` as default (None: the card). The first call compiles the
    program and keeps it in `fn`'s own cache for the checks' later calls."""
    import jax

    def one(job):
        label, fn, args, device = job
        t0 = time.perf_counter()
        out = _on(device, lambda: jax.block_until_ready(fn(*args)))
        return label, out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, min(len(jobs), os.cpu_count() or 1))) as pool:
        done = list(pool.map(one, jobs))
    log(f"first calls: {len(jobs)} programs in {time.perf_counter() - t0:.1f}s "
        "(seconds each, compile included, run concurrently: " + ", ".join(
            f"{label} {s:.1f}" for label, _, s in sorted(done, key=lambda d: -d[2])) + ")")
    return {label: out for label, out, _ in done}


def run_phase(phase, **kwargs):
    """Plan one phase, make its first calls, run its checks."""
    jobs = []
    check = phase(jobs, **kwargs)
    check(first_calls(jobs))


def _batch_states(model, K, seed):
    """K perturbed home states, host float32; for half of them the cube
    sits against the first fingertip so that contact is active."""
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics.engine import _tips_from_frames
    from gym_kmanip_tpu.dynamics.state import SimState
    from gym_kmanip_tpu.ops import kinematics as kin

    rng = np.random.RandomState(seed)
    xp, xq, _ = kin.fk(model, jnp.asarray(model.home_qpos, jnp.float32))
    tip0 = np.asarray(_tips_from_frames(model, xp, xq))[0]
    # joints kept off their limits: the limit force switches on at the
    # bound, where two roundings of the same state may take either branch
    lo, hi = model.jnt_range[:, 0], model.jnt_range[:, 1]
    margin = np.minimum(0.02, 0.1 * (hi - lo))
    q = np.clip(model.home_qpos + 0.05 * rng.randn(K, model.nq), lo + margin, hi - margin)
    ctrl = np.clip(
        model.home_qpos[: model.nu] + 0.05 * rng.randn(K, model.nu),
        model.ctrl_range[:, 0], model.ctrl_range[:, 1],
    )
    near = np.arange(K) % 2 == 0
    cube = np.where(near[:, None], tip0 + [0.02, 0.0, 0.0], [0.15, 0.58, 0.62])
    quat = np.array([1.0, 0, 0, 0]) + 0.05 * rng.randn(K, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    f = np.float32
    return SimState(
        qpos=q.astype(f), qvel=(0.3 * rng.randn(K, model.nq)).astype(f),
        ctrl=ctrl.astype(f),
        cube_pos=(cube + 0.01 * rng.randn(K, 3)).astype(f),
        cube_quat=quat.astype(f),
        cube_linvel=(0.1 * rng.randn(K, 3)).astype(f),
        cube_angvel=(0.3 * rng.randn(K, 3)).astype(f),
        time=np.zeros(K, f),
    )


def _item(tree, i):
    return type(tree)(*(a[i] for a in tree))


def phase_dynamics(jobs, K=256, robots=ROBOTS, regimes=REGIMES):
    """vmap(substep) on the default device against the CPU, item by item."""
    import jax

    from gym_kmanip_tpu.dynamics.engine import substep
    from gym_kmanip_tpu.models import get_model

    cases = []
    for name in robots:
        model = get_model(name)
        states = _batch_states(model, K, seed=len(name))
        for dt, implicit in regimes:
            def one(s, model=model, dt=dt, implicit=implicit):
                return substep(model, s, dt, contact=True, implicit_actuation=implicit)

            label, item = f"substep/{name}/{dt}", jax.jit(one)
            jobs.append((label, jax.jit(jax.vmap(one)), (states,), None))
            jobs.append((f"substep-cpu/{name}/{dt}", item, (_item(states, 0),), _cpu()))
            cases.append((name, dt, implicit, label, item, states))

    def check(results):
        for name, dt, implicit, label, item, states in cases:
            out, (touch, _, _) = results[label]
            refs = [_on(_cpu(), item, _item(states, i)) for i in range(K)]
            ref = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                               *[r[0] for r in refs])
            touch_ref = np.stack([np.asarray(r[1][0]) for r in refs])
            worst = []
            for field, atol in DYN_TOL.items():
                a, b = np.asarray(getattr(out, field)), getattr(ref, field)
                err = np.abs(a - b)
                rel = float((err / np.maximum(np.abs(b), 1e-6)).max())
                worst.append(f"{field} abs {err.max():.2e} rel {rel:.2e}")
                if not np.all(err <= atol + DYN_RTOL * np.abs(b)):
                    raise AssertionError(
                        f"{name} dt={dt}: {field} off the CPU by {err.max():.3e} "
                        f"(tol {atol:.0e} + {DYN_RTOL:.0e}*|cpu|)")
            flips = int((np.asarray(touch) != touch_ref).sum())
            log(f"dynamics {name} K={K} dt={dt} implicit={implicit}: "
                f"{'; '.join(worst)}; touch flips {flips}/{touch_ref.size}, "
                f"active {int(touch_ref.sum())}; tol atol {DYN_TOL} rtol {DYN_RTOL} "
                "(2x each f32 path's bound vs float64)")

    return check


def phase_golden(jobs):
    """Replay the MuJoCo golden servo trace on the default device."""
    import dataclasses

    import jax

    from gym_kmanip_tpu.dynamics.engine import substep
    from gym_kmanip_tpu.dynamics.state import SimState
    from gym_kmanip_tpu.models import get_model

    data = np.load(GOLDEN)
    model = get_model("solo_arm")
    # the golden XML strips frictionloss and disables joint limits
    # (tests/test_dynamics_parity.py)
    model = dataclasses.replace(
        model,
        jnt_frictionloss=np.zeros_like(model.jnt_frictionloss),
        jnt_range=np.tile(np.array([-1e6, 1e6]), (model.nq, 1)),
    )
    n_sub, dt = int(data["n_sub"]), float(data["timestep"])
    f = np.float32
    state = SimState(
        qpos=data["home"].astype(f), qvel=np.zeros(model.nq, f),
        ctrl=data["home"][: model.nu].astype(f),
        cube_pos=np.array([2.0, 2.0, 0.02], f), cube_quat=np.array([1.0, 0, 0, 0], f),
        cube_linvel=np.zeros(3, f), cube_angvel=np.zeros(3, f), time=np.zeros((), f),
    )

    def ctrl_step(s, target):
        s = s._replace(ctrl=target)
        s, _ = jax.lax.scan(
            lambda si, _: (substep(model, si, dt, contact=False)[0], None),
            s, None, length=n_sub,
        )
        return s, s.qpos

    replay = jax.jit(lambda s, t: jax.lax.scan(ctrl_step, s, t)[1])
    args = (state, data["targets"].astype(f))
    jobs.append(("golden", replay, args, None))

    def check(results):
        trace = np.asarray(results["golden"])
        dev = float(np.abs(trace[:, :7] - data["qpos"][:, :7]).max())
        log(f"golden: max arm-joint deviation vs MuJoCo over "
            f"{len(data['targets'])} control steps {dev:.3e} rad "
            f"(bound {GOLDEN_BOUND:.0e})")
        if not dev < GOLDEN_BOUND:
            raise AssertionError(f"golden deviation {dev:.3e} >= {GOLDEN_BOUND}")

    return check


def phase_mppi(jobs, K=256, H=20, n_steps=120, require_lift=True):
    """The flagship closed loop, timed per solve; its first solve replayed
    from the solver's own key, and the replay's rollout costs against the
    CPU."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.dynamics.engine import make_control_step
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.mppi import (
        init_mppi, make_mppi_solver, sample_noise, sigma_per_actuator,
    )
    from gym_kmanip_tpu.mpc.rollout import rollout
    from gym_kmanip_tpu.utils.precision import highest_precision

    ex = importlib.import_module("gym_kmanip_tpu.examples.8_mpc_mppi")
    model = get_model("solo_arm")
    cfg = ex.make_config(horizon=H, n_samples=K)
    cost_fn = ex.make_cost(model)
    mppi_state = init_mppi(model, cfg)
    sim_state = init_state(model, cube_pos=ex.CUBE_SPAWN)
    solver = make_mppi_solver(model, cfg, cost_fn)
    plant_step = make_control_step(model)
    lo = model.ctrl_range[:, 0].astype(np.float32)
    hi = model.ctrl_range[:, 1].astype(np.float32)

    def cost(u):
        return rollout(model, sim_state, u, cost_fn, n_substeps=cfg.n_substeps,
                       dt=cfg.dt, contact=cfg.contact)[0]

    @jax.jit
    @highest_precision
    def replay(ms):
        """mppi_solve's iterations written out: each iteration's candidates
        from the solver's key, and their rollout costs."""
        nominal = proposal = ms.nominal
        rng, cands, costs = ms.rng, [], []
        for _ in range(cfg.n_iters):
            rng, sub = jax.random.split(rng)
            eps = sample_noise(sub, K, H, model.nu,
                               sigma_per_actuator(model, cfg.sigma), cfg.noise_beta)
            cand = jnp.clip(nominal[None] + eps.at[0].set(0.0), lo, hi).at[1].set(proposal)
            c = jax.vmap(cost)(cand)
            w = jax.nn.softmax(-(c - c.min()) / (cfg.temperature * (jnp.std(c) + 1e-6)))
            proposal = jnp.clip(jnp.einsum("k,khu->hu", w, cand), lo, hi)
            nominal = cand[jnp.argmin(c)]
            cands.append(cand)
            costs.append(c)
        return jnp.stack(cands), jnp.stack(costs)

    cost_one = jax.jit(cost)
    jobs.append(("mppi/solver", solver, (mppi_state, sim_state), None))
    jobs.append(("mppi/plant", plant_step, (sim_state, mppi_state.nominal[0]), None))
    jobs.append(("mppi/replay", replay, (mppi_state,), None))
    jobs.append(("mppi/cost-cpu", cost_one, (np.zeros((H, model.nu), np.float32),), _cpu()))

    def check(results):
        ms, u0, J = results["mppi/solver"]  # the example's warm call
        log("mppi: memory_analysis "
            f"{solver.lower(mppi_state, sim_state).compile().memory_analysis()}")
        _, touch_steps, lifted, solve_s = ex.closed_loop(
            solver, plant_step, ms, sim_state, n_steps, log_every=30
        )
        p50, p99 = np.percentile(np.asarray(solve_s) * 1e3, [50, 99])
        log(f"mppi: K={K} H={H} {n_steps} closed-loop steps, per solve median "
            f"{p50:.3f} ms p99 {p99:.3f} ms; touch steps {touch_steps}, lifted={lifted}")
        if require_lift and not lifted:
            raise AssertionError("flagship closed loop did not lift the cube")

        cands, costs = (np.asarray(a) for a in results["mppi/replay"])
        best = int(costs[-1].argmin())
        gap = abs(float(J) - costs[-1, best]) / max(abs(costs[-1, best]), 1e-6)
        du = float(np.abs(np.asarray(u0) - cands[-1, best, 0]).max())
        log(f"mppi: first solve vs its replay: cost {float(J):.6f} vs elite "
            f"{costs[-1, best]:.6f} (rel {gap:.2e}, tol {REPLAY_RTOL:.0e}), u0 max diff "
            f"{du:.2e} (tol 1e-5); elite index per iteration "
            f"{[int(c.argmin()) for c in costs]}")
        if gap > REPLAY_RTOL or du > 1e-5:
            raise AssertionError("the MPPI solve is not the elite of its own replay")
        ref = np.asarray([[_on(_cpu(), cost_one, u) for u in it] for it in cands])
        err = np.abs(costs - ref)
        rel = float((err / np.maximum(np.abs(ref), 1e-6)).max())
        log(f"mppi: {costs.size} replayed rollout costs ({cfg.n_iters} iterations x {K}) "
            f"vs CPU max abs {err.max():.3e} rel {rel:.3e} (rtol {COST_RTOL:.0e}: f32 "
            f"order differences over {cfg.horizon * cfg.n_substeps} substeps); argmin "
            f"{[int(c.argmin()) for c in ref]} on the CPU")
        if not np.allclose(costs, ref, rtol=COST_RTOL, atol=COST_RTOL):
            raise AssertionError(f"rollout costs off the CPU by rel {rel:.3e}")

    return check


def _ilqr_problem(model, H, n_iters, goal_offset=GOAL_OFFSET):
    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.mpc.cost import make_ee_tracking_cost_ilqr
    from gym_kmanip_tpu.ops import kinematics as kin
    from gym_kmanip_tpu.solvers.ilqr import ILQRConfig

    s0 = init_state(model)
    xp, xq, _ = kin.fk(model, s0.qpos)
    p, _ = kin.site_pose(model, xp, xq, "eer_site")
    goal = np.asarray(p) + np.asarray(goal_offset, np.float32)
    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(
        model, goal, w_pos=50.0, w_vel=0.01, w_ctrl=0.001
    )
    cfg = ILQRConfig(horizon=H, n_iters=n_iters, contact=False, reduced_state=True)
    us = np.tile(model.home_qpos[: model.nu].astype(np.float32), (H, 1))
    return cfg, cost_xu, quad_xu, us


def phase_ilqr(jobs, model=None, H=100, n_iters=10, reps=5, ref_iters=1,
               goal_offset=GOAL_OFFSET):
    """The production iLQR solve on the card, timed; the first `ref_iters`
    iterations of its cost trace against the same solve on the CPU."""
    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.solvers.ilqr import make_ilqr_solver

    model = model if model is not None else get_model("torso")
    cfg, cost_xu, quad_xu, us = _ilqr_problem(model, H, n_iters, goal_offset)
    state0 = init_state(model)
    solve = make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu)
    # the same solve cut to `ref_iters` iterations: XLA:CPU takes ~0.7 s per
    # torso horizon step of the vmapped FD linearization, and only the
    # first iteration starts from the same point on both devices
    solve_cpu = make_ilqr_solver(model, cfg._replace(n_iters=ref_iters), cost_xu,
                                 quad_xu=quad_xu)
    jobs.append(("ilqr", solve, (state0, us), None))
    jobs.append(("ilqr/cpu", solve_cpu, (jax.device_put(state0, _cpu()), us), _cpu()))

    def check(results):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = jax.block_until_ready(solve(state0, us))
            times.append(time.perf_counter() - t0)
        tr = np.asarray(r.cost_trace)
        log(f"ilqr: {model.name} H={H} {n_iters} iters, per solve median "
            f"{np.median(times) * 1e3:.3f} ms (min {min(times) * 1e3:.3f}); "
            f"cost trace {np.array2string(tr, precision=6)}")
        if not (np.all(np.diff(tr) <= 1e-5 * max(1.0, abs(tr[0]))) and tr[-1] < tr[0]):
            raise AssertionError(f"iLQR cost trace does not descend: {tr}")
        ref = np.asarray(results["ilqr/cpu"].cost_trace)
        gap = np.abs(tr[:ref_iters] - ref) / np.abs(ref)
        log(f"ilqr: first {ref_iters} iteration(s), card {tr[:ref_iters]} vs CPU {ref}: "
            f"rel {', '.join(f'{g:.2e}' for g in gap)} (rtol {ILQR_RTOL:.0e})")
        if not np.all(gap <= ILQR_RTOL):
            raise AssertionError(f"iLQR cost trace off the CPU: {tr[:ref_iters]} vs {ref}")

    return check


def phase_four_mppi(jobs, n_dev=4, local_k=256, H=20):
    """Sharded MPPI over n_dev cards against a one-card replay of the same
    candidates (same per-card keys, device-major order)."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.mppi import init_mppi, sample_noise, sigma_per_actuator
    from gym_kmanip_tpu.mpc.rollout import rollout
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_mppi_solver
    from gym_kmanip_tpu.utils.precision import highest_precision

    ex = importlib.import_module("gym_kmanip_tpu.examples.8_mpc_mppi")
    model = get_model("solo_arm")
    cfg = ex.make_config(horizon=H, n_samples=local_k * n_dev)._replace(n_iters=1)
    cost_fn = ex.make_cost(model)
    ms = init_mppi(model, cfg)
    ss = init_state(model, cube_pos=ex.CUBE_SPAWN)
    solver = make_sharded_mppi_solver(model, cfg, cost_fn, make_mesh(n_dev))
    lo = model.ctrl_range[:, 0].astype(np.float32)
    hi = model.ctrl_range[:, 1].astype(np.float32)
    sigma = sigma_per_actuator(model, cfg.sigma)

    @jax.jit
    @highest_precision
    def replay(rng, nominal, sim_state):
        _, sub = jax.random.split(rng)
        keys = jax.random.split(sub, n_dev)
        cands = []
        for d in range(n_dev):
            eps = sample_noise(keys[d], local_k, H, model.nu, sigma, cfg.noise_beta)
            if d == 0:
                eps = eps.at[0].set(0.0)
            c = jnp.clip(nominal[None] + eps, lo, hi)
            cands.append(c.at[1].set(nominal) if d == 0 else c)
        cand = jnp.concatenate(cands, axis=0)
        costs = jax.vmap(lambda u: rollout(
            model, sim_state, u, cost_fn, n_substeps=cfg.n_substeps,
            dt=cfg.dt, contact=cfg.contact,
        )[0])(cand)
        return costs, cand

    jobs.append(("four/mppi", solver, (ms, ss), None))
    jobs.append(("four/mppi-replay", replay, (ms.rng, ms.nominal, ss), None))

    def check(results):
        _, u0, J = results["four/mppi"]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(solver(ms, ss))
            times.append(time.perf_counter() - t0)
        costs, cand = (np.asarray(a) for a in results["four/mppi-replay"])
        best = int(costs.argmin())
        gap = abs(float(J) - float(costs[best])) / max(abs(float(costs[best])), 1e-6)
        du = float(np.abs(np.asarray(u0) - cand[best, 0]).max())
        log(f"four/mppi: K={cfg.n_samples} ({local_k} per card) H={H}, per solve "
            f"median {np.median(times) * 1e3:.3f} ms; elite cost {float(J):.5f} vs "
            f"one-card {float(costs[best]):.5f} (rel {gap:.2e}, tol {REPLAY_RTOL:.0e}), "
            f"u0 max diff {du:.2e} (tol 1e-5)")
        if gap > REPLAY_RTOL or du > 1e-5:
            raise AssertionError(f"sharded MPPI elite off the one-card replay by {gap:.2e}")

    return check


def phase_four_ilqr(jobs, n_dev=4, B=16, H=50, n_iters=10, model=None):
    """The sharded iLQR fleet over n_dev cards against the same batch on
    one card, solved by the same entry point over a one-card mesh at the
    same per-card batch shape."""
    import jax

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.parallel.mesh import make_mesh, make_sharded_ilqr_solver
    from gym_kmanip_tpu.solvers.ilqr import flatten_state

    model = model if model is not None else get_model("solo_arm")
    cfg, cost_xu, quad_xu, us = _ilqr_problem(model, H, n_iters)
    s0 = init_state(model)
    solver = make_sharded_ilqr_solver(
        model, cfg, cost_xu, make_mesh(n_dev), s0, B, quad_xu=quad_xu
    )
    rng = np.random.RandomState(0)
    x0 = np.asarray(flatten_state(s0, reduced=True))
    x0s = (x0[None] + 0.01 * rng.randn(B, x0.size)).astype(np.float32)
    uss = (us[None] + 0.01 * rng.randn(B, H, model.nu)).astype(np.float32)
    local = B // n_dev
    one = make_sharded_ilqr_solver(
        model, cfg, cost_xu, make_mesh(1), s0, local, quad_xu=quad_xu
    )
    jobs.append(("four/ilqr", solver, (x0s, uss), None))
    jobs.append(("four/ilqr-one-card", one, (x0s[:local], uss[:local]), None))

    def check(results):
        _, c_sh, tr_sh = results["four/ilqr"]
        t0 = time.perf_counter()
        jax.block_until_ready(solver(x0s, uss))
        per_batch = time.perf_counter() - t0
        c_1 = np.concatenate([
            np.asarray(one(x0s[d * local:(d + 1) * local], uss[d * local:(d + 1) * local])[1])
            for d in range(n_dev)
        ])
        c_sh, tr_sh = np.asarray(c_sh), np.asarray(tr_sh)
        tight = np.isclose(c_sh, c_1, rtol=2e-3, atol=1e-6)
        log(f"four/ilqr: {model.name} B={B} H={H} {n_iters} iters, batch "
            f"{per_batch * 1e3:.3f} ms; {int(tight.sum())}/{B} costs within 2e-3 "
            f"of one card, max rel {float(np.max(np.abs(c_sh - c_1) / np.abs(c_1))):.2e} "
            "(tol 0.10)")
        # discrete line-search choices may flip on near-ties between the two
        # compilations (tests/test_parallel.py): most match tightly, all
        # within 10%, every problem descends
        if tight.sum() < int(0.8 * B) or not np.allclose(c_sh, c_1, rtol=0.10):
            raise AssertionError(f"sharded iLQR off one card: {c_sh} vs {c_1}")
        if not np.all(tr_sh[:, -1] <= tr_sh[:, 0] + 1e-5):
            raise AssertionError("a sharded iLQR problem did not descend")

    return check


def peak_memory():
    import jax

    for d in jax.devices():
        stats = d.memory_stats() or {}
        log(f"memory: {d} peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    check_device(4 if args.four else 1)

    sys.path.insert(0, REPO)
    from gym_kmanip_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    phases = ((phase_four_mppi, phase_four_ilqr) if args.four
              else (phase_dynamics, phase_golden, phase_mppi, phase_ilqr))
    jobs = []
    checks = [(phase.__name__, phase(jobs)) for phase in phases]
    results = first_calls(jobs)
    for name, check in checks:
        t0 = time.perf_counter()
        check(results)
        log(f"{name}: passed in {time.perf_counter() - t0:.1f}s")
    peak_memory()
    log(f"total {time.perf_counter() - t_start:.1f}s")

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
