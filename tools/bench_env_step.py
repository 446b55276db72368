"""Gym env.step throughput: OUR env vs the ACTUAL reference, same host CPU.

The reference's env.step is its entire product surface (50 Hz control bar,
CONTROL_TIMESTEP=0.02 at /root/reference/gym_kmanip/__init__.py:30; its
code comments claim ~1 ms/step, examples/4_teleop.py:109). This tool runs
both implementations on the same machine, same morphology, same action
distribution, and prints one JSON line:

  {"ours_hz": ..., "reference_hz": ..., "speedup": ...,
   "native_ik": true/false}

Both run single-env CPU (JAX_PLATFORMS=cpu): the reference cannot run
anywhere else, and an apples-to-apples host comparison is the honest
parity benchmark — our device story is the batched/MPC path (bench.py), not
the single-env Gym shell. Our step = goals-jit -> native C++ f64 TRF IK
(gym_kmanip_tpu/native) -> core-jit (decode + 10x2ms contact physics + obs
+ reward as one XLA program). The reference's = scipy TRF IK (tens of
MuJoCo-C residual/Jacobian evals) -> 10 native mj_steps -> numpy obs.

Run: python tools/bench_env_step.py [--steps N]
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"  # the reference runs nowhere else

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_WARM = 5


def _action_seq(arms, n, seed=3):
    import numpy as np

    rng = np.random.RandomState(seed)
    seq = []
    for _ in range(n):
        act = {}
        for side in arms:
            act[f"{side}_pos"] = rng.uniform(-1, 1, 3).astype(np.float32)
            act[f"{side}_orn"] = np.zeros(3, dtype=np.float32)
            act[f"grip_{side[-1]}"] = np.zeros(1, dtype=np.float32)
        seq.append(act)
    return seq


def _timed_steps(env, seq, n_steps, reps=2):
    """Best-of-`reps` sustained step rate (host scheduling jitter on a
    shared 4-core box moves single-shot numbers by ~20%)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for i, a in enumerate(seq[N_WARM:]):
            _, _, term, trunc, _ = env.step(a)
            if term or trunc:
                env.reset(seed=i)
        best = min(best, time.perf_counter() - t0)
    return n_steps / best


def bench_ours(env_id, arms, n_steps):
    import gymnasium as gym

    import gym_kmanip_tpu  # noqa: F401 -- registers env ids

    env = gym.make(env_id)
    env.reset(seed=0)
    seq = _action_seq(arms, n_steps + N_WARM)
    for a in seq[:N_WARM]:  # warm: compiles goals-jit + core-jit
        env.step(a)
    rate = _timed_steps(env, seq, n_steps)
    env.close()
    return rate


def bench_reference(env_id, arms, n_steps):
    """Run the actual reference env against mesh-free assets (the same
    build tests/test_env_parity.py's golden traces use)."""
    import tempfile

    from tools.make_golden_env import ENVS, build_env_xml

    assets = tempfile.mkdtemp(prefix="kmanip_ref_bench_")
    builtin, xml_name, _, _ = ENVS[env_id]
    with open(os.path.join(assets, xml_name), "w") as f:
        f.write(build_env_xml(builtin, xml_name))

    sys.path.insert(0, "/root/reference")
    import gym_kmanip as ref_k

    ref_k.ASSETS_DIR = assets
    import gymnasium as gym

    env = gym.make(env_id)  # reference registration wins after its import
    env.reset(seed=0)
    seq = _action_seq(arms, n_steps + N_WARM)
    for a in seq[:N_WARM]:
        env.step(a)
    rate = _timed_steps(env, seq, n_steps)
    env.close()
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--env", default="KManipSoloArm")
    args = ap.parse_args()
    arms = ("eer", "eel") if args.env != "KManipSoloArm" else ("eer",)

    from gym_kmanip_tpu import native

    # ours FIRST: importing the reference package re-registers the shared
    # env ids, so order is load-bearing (see tools/make_golden_env.py)
    ours = bench_ours(args.env, arms, args.steps)
    try:
        ref = bench_reference(args.env, arms, args.steps)
    except Exception as e:  # noqa: BLE001 -- reference build can fail
        print(json.dumps({
            "ours_hz": round(ours, 2), "reference_hz": None,
            "speedup": None, "native_ik": native.available(),
            "error": f"{type(e).__name__}: {e}",
        }))
        return
    print(json.dumps({
        "ours_hz": round(ours, 2),
        "reference_hz": round(ref, 2),
        "speedup": round(ours / ref, 3),
        "native_ik": native.available(),
    }))


if __name__ == "__main__":
    main()
