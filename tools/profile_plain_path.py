"""What XLA makes of the plain path on the GPU: time and kernel launches.

    python tools/profile_plain_path.py [--out chiprun_out/plain_path.json]

Two measurements, each timed with `block_until_ready` (median of 5) and
traced once with `jax.profiler` to count the device kernels it launches:

- the rollout substep: `lax.scan` of 100 `vmap(substep)` steps at K=256,
  with contact, at the flagship rollout's 2 ms stable-PD setting, for each
  robot: microseconds and kernels per substep;
- the iLQR backward pass: the serial `lax.scan` sweep
  (`ilqr.riccati_sweep`) and the associative-scan sweep
  (`parallel_lqr.backward_associative`) at torso H=100 (n=40, m=20) and
  solo H=50 (n=20, m=10): milliseconds per sweep and kernels per step.

Needs a GPU; prints one JSON line per measurement and writes them all to
--out.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_STEPS = 100  # substeps per traced scan


def _median_seconds(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_kernels(fn, *args):
    """(kernel count, kernel seconds, top kernel names) of one call, read
    from the GPU planes of a profiler trace."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(d, "plugins", "profile", "*", "*.xplane.pb"))[0]
        data = ProfileData.from_file(path)
    count, busy_ns, names = 0, 0, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernels sit on the stream lines; "XLA Ops"/"XLA Modules"
            # lines repeat them at a coarser grain
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                count += 1
                busy_ns += ev.duration_ns
                names[ev.name] = names.get(ev.name, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    return count, busy_ns * 1e-9, top


def substep_rows(K=256):
    import jax

    import chip_smoke
    from gym_kmanip_tpu.dynamics.engine import substep
    from gym_kmanip_tpu.models import get_model

    rows = []
    for name in ("solo_arm", "dual_arm", "torso"):
        model = get_model(name)
        states = chip_smoke._batch_states(model, K, seed=0)
        step = jax.vmap(lambda s: substep(model, s, 0.002, contact=True,
                                          implicit_actuation=True)[0])
        run = jax.jit(lambda s: jax.lax.scan(
            lambda c, _: (step(c), None), s, None, length=N_STEPS)[0])
        sec = _median_seconds(run, states)
        n_k, k_sec, top = device_kernels(run, states)
        rows.append({
            "what": f"substep_{name}_K{K}", "us_per_substep": sec / N_STEPS * 1e6,
            "kernels_per_substep": n_k / N_STEPS,
            "kernel_us_per_substep": k_sec / N_STEPS * 1e6, "top_kernels": top,
        })
    return rows


def _lqr_problem(H, n, m, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    A = (0.05 * rng.randn(H, n, n) + 0.95 * np.eye(n)).astype(f)
    B = (0.1 * rng.randn(H, n, m)).astype(f)
    W = rng.randn(H, n, n) / np.sqrt(n)
    cxx = (W @ W.transpose(0, 2, 1) + np.eye(n)).astype(f)
    Wu = rng.randn(H, m, m) / np.sqrt(m)
    cuu = (Wu @ Wu.transpose(0, 2, 1) + np.eye(m)).astype(f)
    return dict(A=A, B=B, cx=rng.randn(H, n).astype(f), cu=rng.randn(H, m).astype(f),
                cxx=cxx, cuu=cuu, cux=(0.05 * rng.randn(H, m, n)).astype(f),
                VxT=rng.randn(n).astype(f), VxxT=np.eye(n, dtype=f))


def riccati_rows():
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.solvers.ilqr import riccati_sweep
    from gym_kmanip_tpu.solvers.parallel_lqr import LQRProblem, backward_associative

    rows = []
    for label, H, n, m in (("torso", 100, 40, 20), ("solo", 50, 20, 10)):
        p = _lqr_problem(H, n, m)
        scan = jax.jit(lambda p: riccati_sweep(
            p["A"], p["B"], p["cx"], p["cu"], p["cxx"], p["cuu"], p["cux"],
            p["VxT"], p["VxxT"], 1e-6, jnp.float32(0.0)))
        assoc = jax.jit(lambda p: backward_associative(LQRProblem(
            A=p["A"], B=p["B"], d=jnp.zeros((H, n), jnp.float32), Q=p["cxx"],
            q=p["cx"], R=p["cuu"] + 1e-6 * jnp.eye(m), r=p["cu"], L=p["cux"],
            Qf=p["VxxT"], qf=p["VxT"])))
        for kind, fn in (("scan", scan), ("associative", assoc)):
            sec = _median_seconds(fn, p)
            n_k, k_sec, top = device_kernels(fn, p)
            rows.append({
                "what": f"riccati_{kind}_{label}_H{H}_n{n}_m{m}",
                "ms_per_sweep": sec * 1e3, "kernels_per_step": n_k / H,
                "kernel_ms_per_sweep": k_sec * 1e3, "top_kernels": top,
            })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "plain_path.json"))
    args = ap.parse_args()
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"profile_plain_path: backend {jax.default_backend()!r}, not 'gpu'")
    from gym_kmanip_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import chip_smoke

    head = {"device": jax.devices()[0].device_kind, "cards": chip_smoke.card_lines()}
    print(json.dumps(head), flush=True)
    rows = []
    for measure in (substep_rows, riccati_rows):
        for row in measure():
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**head, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
