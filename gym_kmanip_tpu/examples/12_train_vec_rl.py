"""On-device RL: PPO over a batch of vectorized KManip envs.

No reference analog (its 6_train_from_dataset.py is offline BC from
recorded episodes); this is the on-device on-policy path the vectorized
env exists for: N envs stepped as ONE jitted program (KManipVecEnv, fused
Pallas physics under vmap), a flax policy/value net, and jitted PPO
updates — the host only shuttles (N, ...) batches between the two jitted
programs.

Two modes:
  * state (default): MLP policy on the QPos observation vector
  * --vision: CNN policy on on-device-rendered grip-camera frames
    (KManipVecEnv renders every env's cameras inside the same jitted
    step; render_hw shrinks frames to RL size)

Run: python -m gym_kmanip_tpu.examples.12_train_vec_rl [--vision]
"""

import sys
import time
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import linen as nn

from gym_kmanip_tpu.env.vec_env import KManipVecEnv

N_ENVS = 64
T_ROLLOUT = 16
N_UPDATES = 30
PPO_EPOCHS = 4
CLIP = 0.2
GAMMA = 0.97
LAM = 0.95
LR = 3e-4
VISION_HW = (32, 32)


class MLPPolicy(nn.Module):
    act_dim: int

    @nn.compact
    def __call__(self, x):
        x = nn.tanh(nn.Dense(128)(x))
        x = nn.tanh(nn.Dense(128)(x))
        mean = nn.Dense(self.act_dim)(x)
        value = nn.Dense(1)(nn.tanh(nn.Dense(64)(x)))[..., 0]
        log_std = self.param("log_std", lambda *_: -0.7 * jnp.ones(self.act_dim))
        return mean, log_std, value


class CNNPolicy(nn.Module):
    act_dim: int

    @nn.compact
    def __call__(self, img):
        x = img.astype(jnp.float32) / 255.0
        x = nn.relu(nn.Conv(16, (3, 3), strides=2)(x))
        x = nn.relu(nn.Conv(32, (3, 3), strides=2)(x))
        x = x.reshape(x.shape[:-3] + (-1,))
        x = nn.tanh(nn.Dense(128)(x))
        mean = nn.Dense(self.act_dim)(x)
        value = nn.Dense(1)(nn.tanh(nn.Dense(64)(x)))[..., 0]
        log_std = self.param("log_std", lambda *_: -0.7 * jnp.ones(self.act_dim))
        return mean, log_std, value


def obs_to_net_input(obs: Dict[str, np.ndarray], vision: bool) -> np.ndarray:
    if vision:
        return obs["camera/grip_r"]
    return np.concatenate(
        [obs[n] for n in ("q_pos", "q_vel", "cube_pos", "cube_orn") if n in obs],
        axis=-1,
    )


def split_action(flat: np.ndarray, act_spec) -> Dict[str, np.ndarray]:
    out, i = {}, 0
    for name, dim in act_spec:
        out[name] = flat[:, i : i + dim]
        i += dim
    return out


def make_train(net, act_dim):
    tx = optax.adam(LR)

    @jax.jit
    def policy_step(params, obs, key):
        mean, log_std, value = net.apply(params, obs)
        noise = jax.random.normal(key, mean.shape)
        act = jnp.tanh(mean + noise * jnp.exp(log_std))
        # log-prob of the pre-tanh gaussian (tanh correction constant-ish
        # at these scales; PPO ratio only needs consistency)
        logp = -0.5 * jnp.sum(
            noise**2 + 2 * log_std + jnp.log(2 * jnp.pi), axis=-1
        )
        return act, logp, value

    @jax.jit
    def gae(rewards, values, last_value):
        # rewards/values: (T, N)
        def body(carry, rv):
            adv_next, v_next = carry
            r, v = rv
            delta = r + GAMMA * v_next - v
            adv = delta + GAMMA * LAM * adv_next
            return (adv, v), adv

        (_, _), advs = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            (rewards, values), reverse=True,
        )
        returns = advs + values
        advs = (advs - advs.mean()) / (advs.std() + 1e-6)
        return advs, returns

    @jax.jit
    def ppo_update(params, opt, obs, acts, logp_old, advs, returns):
        def loss_fn(p):
            mean, log_std, value = net.apply(p, obs)
            pre = jnp.arctanh(jnp.clip(acts, -0.999, 0.999))
            noise = (pre - mean) / jnp.exp(log_std)
            logp = -0.5 * jnp.sum(
                noise**2 + 2 * log_std + jnp.log(2 * jnp.pi), axis=-1
            )
            ratio = jnp.exp(logp - logp_old)
            pg = -jnp.minimum(
                ratio * advs, jnp.clip(ratio, 1 - CLIP, 1 + CLIP) * advs
            ).mean()
            vloss = jnp.mean((value - returns) ** 2)
            ent = jnp.sum(log_std)
            return pg + 0.5 * vloss - 1e-3 * ent

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    return tx, policy_step, gae, ppo_update


def train(env_id="KManipSoloArm", vision=False, n_updates=N_UPDATES,
          n_envs=N_ENVS, seed=0, t_rollout=T_ROLLOUT, log=print):
    env = KManipVecEnv(
        env_id, n_envs, seed=seed,
        render_hw=VISION_HW if vision else None,
    )
    obs = env.reset(seed=seed)
    # action layout from the env config (EE-delta or direct joint targets)
    dims = {
        "eer_pos": 3, "eer_orn": 3, "eel_pos": 3, "eel_orn": 3,
        "grip_r": 1, "grip_l": 1,
        "q_pos_r": 0 if env.cfg.q_id_r_mask is None else len(env.cfg.q_id_r_mask),
        "q_pos_l": 0 if env.cfg.q_id_l_mask is None else len(env.cfg.q_id_l_mask),
    }
    act_spec = [(n, dims[n]) for n in env.cfg.act_list if dims.get(n)]
    act_dim = sum(d for _, d in act_spec)
    net = (CNNPolicy if vision else MLPPolicy)(act_dim)
    x0 = jnp.asarray(obs_to_net_input(obs, vision))
    rng = jax.random.PRNGKey(seed)
    rng, sub = jax.random.split(rng)
    params = net.init(sub, x0)
    tx, policy_step, gae, ppo_update = make_train(net, act_dim)
    opt = tx.init(params)

    mean_rewards = []
    for upd in range(n_updates):
        O, A, LP, V, R = [], [], [], [], []
        for _ in range(t_rollout):
            x = jnp.asarray(obs_to_net_input(obs, vision))
            rng, sub = jax.random.split(rng)
            act, logp, value = policy_step(params, x, sub)
            obs, reward, term, trunc, _ = env.step(
                split_action(np.asarray(act), act_spec)
            )
            O.append(x); A.append(act); LP.append(logp); V.append(value)
            R.append(jnp.asarray(reward))
        x = jnp.asarray(obs_to_net_input(obs, vision))
        _, _, last_v = policy_step(params, x, rng)
        advs, returns = gae(jnp.stack(R), jnp.stack(V), last_v)
        flat = lambda t: jnp.reshape(jnp.stack(t), (-1,) + t[0].shape[1:])
        for _ in range(PPO_EPOCHS):
            params, opt, loss = ppo_update(
                params, opt, flat(O), flat(A), flat(LP),
                advs.reshape(-1), returns.reshape(-1),
            )
        mr = float(jnp.stack(R).mean())
        mean_rewards.append(mr)
        if upd % 5 == 0:
            log(f"update {upd}: mean reward {mr:.4f} loss {float(loss):.4f}")
    return params, mean_rewards


def main():
    vision = "--vision" in sys.argv
    t0 = time.time()
    params, mrs = train(vision=vision)
    print(
        f"trained {N_UPDATES} PPO updates x {N_ENVS} envs "
        f"({'vision' if vision else 'state'}) in {time.time()-t0:.1f}s; "
        f"mean reward {mrs[0]:.4f} -> {mrs[-1]:.4f}"
    )


if __name__ == "__main__":
    main()
