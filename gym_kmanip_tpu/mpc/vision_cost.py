"""Vision-in-the-loop MPC: rendered observations feeding a learned cost.

BASELINE config 5 ("KManipSoloArmVision: gripper/head/overhead cams rendered
obs feeding learned-cost MPC rollouts"): every rollout state is rendered
on-device by the raycaster (gym_kmanip_tpu.render) and scored by a small
flax CNN -- renderer and network both live inside the vmapped rollout, so
thousands of render+infer passes compile into one program (the renders
batch into (K, h, w, 3) tensors for one batched conv).

The CNN can be trained (e.g. regress the true cube-gripper distance from
pixels, `fit_distance_cost`) or loaded; with no training it still exercises
the full pipeline.
"""

from functools import partial
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from flax import linen as nn

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics.state import SimState, StepAux
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.render.raycast import render_camera


class CostCNN(nn.Module):
    """Tiny conv net: (h, w, 3) float in [0,1] -> scalar cost."""

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(8, (3, 3), strides=2)(x))
        x = nn.relu(nn.Conv(16, (3, 3), strides=2)(x))
        x = x.reshape((x.shape[0], -1)) if x.ndim == 4 else x.reshape(-1)
        x = nn.relu(nn.Dense(32)(x))
        return nn.Dense(1)(x).squeeze(-1)


def make_vision_cost(
    model: RobotModel,
    params: Any,
    cam_name: str = "grip_r",
    height: int = 40,
    width: int = 60,
    w_vision: float = 1.0,
    w_vel: float = 0.01,
) -> Callable:
    """Returns cost_fn(state, aux, ctrl) that renders `cam_name` at the
    rollout state and runs the CNN on the frame (low-res grip camera by
    default, Cam spec reference __init__.py:158-160)."""
    net = CostCNN()

    def cost_fn(state: SimState, aux: StepAux, ctrl: jax.Array) -> jax.Array:
        img = render_camera(
            model, cam_name, state.qpos, state.cube_pos, state.cube_quat,
            height, width,
        )
        x = img.astype(jnp.float32) / 255.0
        c = net.apply(params, x)
        return w_vision * c + w_vel * jnp.sum(state.qvel**2)

    return cost_fn


def init_cost_params(rng: jax.Array, height: int = 40, width: int = 60) -> Any:
    return CostCNN().init(rng, jnp.zeros((height, width, 3), dtype=jnp.float32))


def fit_distance_cost(
    model: RobotModel,
    rng: jax.Array,
    n_samples: int = 256,
    n_steps: int = 200,
    height: int = 40,
    width: int = 60,
    cam_name: str = "grip_r",
    around_home: float = 0.5,
) -> Any:
    """Self-supervised pre-training: regress the true EE-cube distance from
    rendered frames over random robot/cube configurations, so the learned
    cost decreases as the gripper approaches the cube.

    `around_home` restricts the joint sampling to home +- that many
    radians (clipped to the ranges): a CNN fit on full-range poses
    regresses the global distance scale but collapses to the mean inside
    the cm-scale regime MPC actually operates in (measured: constant
    cost along a displaced->home sweep); fitting on the operative
    distribution is what makes the learned cost resolve it. Pass None
    for the full joint range."""
    import optax

    from gym_kmanip_tpu.ops import kinematics as kin

    lo = jnp.asarray(model.jnt_range[:, 0].clip(-3.14), dtype=jnp.float32)
    hi = jnp.asarray(model.jnt_range[:, 1].clip(max=3.14), dtype=jnp.float32)
    if around_home is not None:
        home = jnp.asarray(model.home_qpos, dtype=jnp.float32)
        lo = jnp.maximum(lo, home - around_home)
        hi = jnp.minimum(hi, home + around_home)
    spawn = jnp.asarray(k.CUBE_SPAWN_RANGE, dtype=jnp.float32)

    rng, k1, k2, k3 = jax.random.split(rng, 4)
    qs = jax.random.uniform(k1, (n_samples, model.nq), minval=lo, maxval=hi)
    cubes = jax.random.uniform(
        k2, (n_samples, 3), minval=spawn[:, 0], maxval=spawn[:, 1]
    )
    cube_quat = jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype=jnp.float32), (n_samples, 1))

    @jax.jit
    @jax.vmap
    def make_example(q, cube):
        img = render_camera(model, cam_name, q, cube, cube_quat[0], height, width)
        xp, xq, _ = kin.fk(model, q)
        ee, _ = kin.site_pose(model, xp, xq, "eer_site")
        return img.astype(jnp.float32) / 255.0, jnp.linalg.norm(ee - cube)

    imgs, dists = make_example(qs, cubes)

    net = CostCNN()
    params = net.init(k3, imgs[0])
    # the distance signal lives in a few pixels (the cube/EE are ~2-4 px
    # from the top camera): a flat 1e-3 adam plateaus at the constant-mean
    # predictor, while a hot start overshoots once the batch is memorized
    # — a decaying schedule gets through the plateau and then anneals
    tx = optax.adam(
        optax.exponential_decay(
            3e-3, transition_steps=max(n_steps // 4, 1), decay_rate=0.5
        )
    )
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            pred = jax.vmap(lambda im: net.apply(p, im))(imgs)
            return jnp.mean((pred - dists) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    for _ in range(n_steps):
        params, opt, loss = step(params, opt)
    return params


class CubePosCNN(nn.Module):
    """(h, w, 3) float in [0,1] -> cube position, normalized to the spawn
    box (sub-pixel regression; the cube subtends only a few pixels from
    the overhead camera, so predicting in normalized spawn coordinates
    conditions the problem)."""

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(16, (3, 3), strides=2)(x))
        x = nn.relu(nn.Conv(32, (3, 3), strides=2)(x))
        x = nn.relu(nn.Conv(32, (3, 3), strides=2)(x))
        x = x.reshape((x.shape[0], -1)) if x.ndim == 4 else x.reshape(-1)
        x = nn.relu(nn.Dense(64)(x))
        return nn.Dense(3)(x)


def fit_cube_pos_estimator(
    model: RobotModel,
    rng: jax.Array,
    n_samples: int = 512,
    n_steps: int = 1500,
    height: int = 64,
    width: int = 96,
    cam_name: str = "top",
    around_home: float = 0.4,
    batch: int = 128,
) -> Tuple[Any, Callable]:
    """Perception for pick-from-pixels (VERDICT r2 next #5): regress the
    cube's world position from overhead renders over random (arm pose,
    cube spawn) pairs. Returns (params, estimate_fn) where
    estimate_fn(img_float01) -> cube_pos (world meters).

    The training distribution matters: arm poses near home (the regime a
    pick episode's FIRST frames see — later frames can occlude the cube,
    which the caller handles by dead-reckoning, examples/14) and spawns
    over the full CUBE_SPAWN_RANGE."""
    import optax

    lo = jnp.asarray(model.jnt_range[:, 0].clip(-3.14), dtype=jnp.float32)
    hi = jnp.asarray(model.jnt_range[:, 1].clip(max=3.14), dtype=jnp.float32)
    home = jnp.asarray(model.home_qpos, dtype=jnp.float32)
    lo = jnp.maximum(lo, home - around_home)
    hi = jnp.minimum(hi, home + around_home)
    spawn = jnp.asarray(k.CUBE_SPAWN_RANGE, dtype=jnp.float32)
    mid = (spawn[:, 0] + spawn[:, 1]) / 2
    half = jnp.maximum((spawn[:, 1] - spawn[:, 0]) / 2, 1e-3)

    rng, k1, k2, k3 = jax.random.split(rng, 4)
    qs = jax.random.uniform(k1, (n_samples, model.nq), minval=lo, maxval=hi)
    cubes = jax.random.uniform(
        k2, (n_samples, 3), minval=spawn[:, 0], maxval=spawn[:, 1]
    )
    quat0 = jnp.asarray([1.0, 0, 0, 0], dtype=jnp.float32)

    @jax.jit
    @jax.vmap
    def make_example(q, cube):
        img = render_camera(model, cam_name, q, cube, quat0, height, width)
        return img.astype(jnp.float32) / 255.0, (cube - mid) / half

    imgs, targets = make_example(qs, cubes)

    net = CubePosCNN()
    params = net.init(k3, imgs[0])
    tx = optax.adam(
        optax.exponential_decay(
            3e-3, transition_steps=max(n_steps // 4, 1), decay_rate=0.5
        )
    )
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, key):
        idx = jax.random.randint(key, (batch,), 0, imgs.shape[0])

        def loss_fn(p):
            pred = net.apply(p, imgs[idx])
            return jnp.mean((pred - targets[idx]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    key = rng
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        params, opt, loss = step(params, opt, sub)

    def estimate(img01: jax.Array) -> jax.Array:
        return net.apply(params, img01) * half + mid

    return params, jax.jit(estimate)
