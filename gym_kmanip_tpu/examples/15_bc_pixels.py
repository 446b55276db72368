"""Pixels-to-control BC: clone the MPPI pick expert from RENDERED frames.

The zoo's pixels artifact (bc_pixels_solo): a CNN policy whose ONLY cube
information is the overhead camera image — proprioception (qpos, qvel)
plus pixels in, ctrl out. Unlike examples/14 (CNN cube-pose estimator
feeding a verified MPC), this is a single end-to-end network, deployable
as `zoo.load_policy("bc_pixels_solo")` — the returned closure renders its
own observation with the on-device raycaster, so it drops into the same
closed-loop plant API as the state policies.

Training data is FREE given the state pipeline: the examples/13 expert
episodes (+ DAgger labels) store (qpos, qvel, cube_pose, expert ctrl)
per step, and the raycaster is a deterministic function of exactly those
states — so the frames are re-rendered offline in batches instead of
re-simulating anything.

Run: python -m gym_kmanip_tpu.examples.15_bc_pixels <data_dir>
"""

import glob
import importlib
import json
import os
import sys
import time

import h5py
import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.dynamics.engine import make_control_step
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.render.raycast import render_camera

H_PX, W_PX, CAM = 64, 96, "top"

_bc = importlib.import_module("gym_kmanip_tpu.examples.13_bc_pick")


def load_states(data_dir, model):
    """(qpos, qvel, cube_pose, action) arrays from the 13_bc_pick dataset
    (successful expert episodes + any saved DAgger labels)."""
    nq = model.nq
    xs, ys = [], []
    for path in sorted(glob.glob(os.path.join(data_dir, "episode_*.hdf5"))):
        with h5py.File(path, "r") as f:
            if not bool(f.attrs.get("expert_lifted", True)):
                continue
            n = int(f.attrs.get("ep_len", f["action"].shape[0]))
            x = np.concatenate(
                [f["observations/qpos"][:n], f["observations/qvel"][:n],
                 f["observations/cube_pose"][:n]], axis=1)
            xs.append(x)
            ys.append(f["action"][:n])
    dag = os.path.join(data_dir, "dagger_labels.npz")
    if os.path.exists(dag):
        d = np.load(dag)
        xs.append(d["X"])
        ys.append(d["Y"])
    X = np.concatenate(xs).astype(np.float32)
    Y = np.concatenate(ys).astype(np.float32)
    return X[:, :nq], X[:, nq:2*nq], X[:, 2*nq:], Y


def render_frames(model, qpos, cube_pose, batch=128, log=print):
    """Re-render the overhead frames for recorded states, in batches."""
    rf = jax.jit(jax.vmap(
        lambda q, cp, cq: render_camera(model, CAM, q, cp, cq, H_PX, W_PX)
    ))
    imgs = []
    t0 = time.time()
    for i in range(0, qpos.shape[0], batch):
        q = jnp.asarray(qpos[i:i+batch])
        cp = jnp.asarray(cube_pose[i:i+batch, :3])
        cq = jnp.asarray(cube_pose[i:i+batch, 3:7])
        imgs.append(np.asarray(rf(q, cp, cq)))
    log(f"rendered {qpos.shape[0]} frames in {time.time()-t0:.1f}s")
    return np.concatenate(imgs)


def train(data_dir, n_steps=6000, batch=64, lr=1e-3, seed=0, log=print,
          model_name="solo_arm"):
    import optax

    from gym_kmanip_tpu.zoo import _bc_pixels_cnn

    model = get_model(model_name)
    qpos, qvel, cube_pose, Y = load_states(data_dir, model)
    imgs = render_frames(model, qpos, cube_pose, log=log)
    P = np.concatenate([qpos, qvel], axis=1)
    mu, sd = P.mean(0), P.std(0) + 1e-6
    Pn = (P - mu) / sd
    lo, hi = model.ctrl_range[:, 0], model.ctrl_range[:, 1]
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    Yn = np.clip((Y - mid) / half, -1, 1)

    net = _bc_pixels_cnn(out_dim=model.nu)
    key = jax.random.PRNGKey(seed)
    params = net.init(key, jnp.zeros((1, H_PX, W_PX, 3)),
                      jnp.zeros((1, Pn.shape[1])))
    tx = optax.adam(lr)
    opt = tx.init(params)
    # dataset stays a jit ARGUMENT (device-resident across calls), never a
    # closure constant: a captured device array becomes a hidden program
    # input baked into every executable; images stay uint8 on device and
    # normalize per-minibatch
    imgs_d = jax.device_put(jnp.asarray(imgs))  # (N, H, W, 3) uint8
    Pd = jax.device_put(jnp.asarray(Pn, jnp.float32))
    Yd = jax.device_put(jnp.asarray(Yn, jnp.float32))

    @jax.jit
    def step(params, opt, key, imgs_a, P_a, Y_a):
        idx = jax.random.randint(key, (batch,), 0, P_a.shape[0])

        def loss_fn(p):
            im = imgs_a[idx].astype(jnp.float32) / 255.0
            pred = net.apply(p, im, P_a[idx])
            return jnp.mean((pred - Y_a[idx]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    for i in range(n_steps):
        key, sub = jax.random.split(key)
        params, opt, loss = step(params, opt, sub, imgs_d, Pd, Yd)
        if i % max(1, n_steps // 5) == 0:
            log(f"pixels bc step {i}: loss {float(loss):.5f}")

    stats = dict(mu=mu, sd=sd, mid=mid, half=half)

    def policy(state):
        img = render_camera(
            model, CAM, state.qpos, state.cube_pos, state.cube_quat,
            H_PX, W_PX,
        ).astype(jnp.float32) / 255.0
        pn = (jnp.concatenate([state.qpos, state.qvel]) - stats["mu"]) / stats["sd"]
        yn = net.apply(params, img[None], pn[None])[0]
        return yn * stats["half"] + stats["mid"]

    return jax.jit(policy), params, stats


def main():
    data_dir = sys.argv[1]
    policy, params, stats = train(data_dir)
    rate = _bc.evaluate(policy, n_evals=12, ep_len=120,
                        spawn_range=_bc.SPAWN_RANGE)
    print(json.dumps({"metric": "bc_pixels_pick_success_rate",
                      "value": rate, "unit": "fraction",
                      "vs_baseline": rate}))


if __name__ == "__main__":
    main()
