"""Vectorized env: N independent KManip envs stepped as ONE program.

No reference analog (the reference's only batch is 1 env, SURVEY.md §2.4);
this is the RL-training counterpart of the MPC rollout fan-out: the whole
(decode -> IK -> physics -> obs -> reward) core from env/task.py is vmapped
over an (N, ...) state batch, so the physics substeps of N envs run as one
batched program. Episode accounting (step counts, truncation, auto-reset with fresh cube
spawns) runs on-device too -- a training loop touches the host only for its
own policy.

API follows the gymnasium VectorEnv conventions (autoreset on truncation,
batched obs/reward/terminated/truncated) without depending on its class
hierarchy.
"""

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.env.config import CONFIGS, EnvConfig
from gym_kmanip_tpu.env.task import TaskOut, _decode_action, _observe, _reward
from gym_kmanip_tpu.dynamics.engine import control_step
from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.models import get_model


class KManipVecEnv:
    def __init__(
        self,
        env_id: str,
        num_envs: int,
        seed: int = 0,
        render_hw: Optional[Tuple[int, int]] = None,
    ):
        """Vision envs render on-device too: each camera in cfg.obs_list is
        vmapped over the env batch inside the same jitted step (the
        raycaster is pure JAX). `render_hw` overrides the Cam spec
        resolution (RL from pixels usually wants 64-128 px, not the
        logging resolution)."""
        if env_id not in CONFIGS:
            raise KeyError(f"unknown env id {env_id}; one of {list(CONFIGS)}")
        # batched pipelines keep IK fully on-device (the f32 jittable TRF):
        # a pure_callback inside the vmapped step would serialize N host
        # solves per step. Single-env parity keeps the f64 host solver
        # (EnvConfig.ik_host64).
        import dataclasses

        self.cfg: EnvConfig = dataclasses.replace(
            CONFIGS[env_id], ik_host64=False
        )
        self.cameras = [
            k.CAMERAS[o.split("/")[-1]] for o in self.cfg.obs_list if "camera" in o
        ]
        self.render_hw = render_hw
        self.num_envs = num_envs
        self.model = get_model(self.cfg.mjcf_filename)
        self._rng = jax.random.PRNGKey(seed)
        cfg, model = self.cfg, self.model

        # numpy (HOST) on purpose: a device array captured by the jitted
        # closures below would become a hidden program input
        # (tests/test_no_device_closures.py)
        spawn = np.asarray(k.CUBE_SPAWN_RANGE, dtype=np.float32)

        def reset_one(key) -> SimState:
            from gym_kmanip_tpu.dynamics.state import init_state

            cube = jax.random.uniform(
                key, (3,), minval=spawn[:, 0], maxval=spawn[:, 1]
            )
            return init_state(model, cube_pos=cube)

        def step_one(state: SimState, action: Dict[str, jax.Array], steps, key):
            ctrl, qpos_ik, mocap_pos, mocap_quat = _decode_action(
                model, cfg, state, action
            )
            qpos_pre = state.qpos
            state = state._replace(qpos=qpos_ik)
            state, aux = control_step(model, state, ctrl, qpos_force=qpos_pre)
            reward = _reward(model, cfg, state, aux)
            steps = steps + 1
            truncated = steps >= cfg.max_episode_steps
            # autoreset (gymnasium 0.29 vector semantics): fresh episode
            # state on truncation, fresh cube spawn from the per-env key.
            # The pre-reset state is returned too so step() can surface the
            # ending episode's true last observation as
            # info["final_observation"] (value bootstrapping at truncation
            # needs it; silently substituting the fresh obs was VERDICT r2
            # weak #9).
            state_final = state
            fresh = reset_one(key)
            state = jax.tree.map(
                lambda a, b: jnp.where(truncated, a, b), fresh, state
            )
            steps = jnp.where(truncated, 0, steps)
            obs = _observe(model, cfg, state)
            return state, state_final, obs, reward, truncated, steps

        cameras, render_hw_l = self.cameras, render_hw

        def cam_obs(states) -> Dict[str, jax.Array]:
            from gym_kmanip_tpu.render.raycast import render_camera

            out = {}
            for cam in cameras:
                h, w = render_hw_l if render_hw_l is not None else (cam.h, cam.w)
                out[cam.log_name] = jax.vmap(
                    lambda s: render_camera(
                        model, cam.name, s.qpos, s.cube_pos, s.cube_quat, h, w
                    )
                )(states)
            return out

        @jax.jit
        def reset_all(key):
            keys = jax.random.split(key, num_envs)
            states = jax.vmap(reset_one)(keys)
            obs = jax.vmap(partial(_observe, model, cfg))(states)
            obs.update(cam_obs(states))
            return states, obs

        @jax.jit
        def step_all(states, actions, steps, key):
            keys = jax.random.split(key, num_envs)
            states, states_final, obs, reward, truncated, steps = jax.vmap(
                step_one
            )(states, actions, steps, keys)
            obs.update(cam_obs(states))
            return states, states_final, obs, reward, truncated, steps

        @jax.jit
        def observe_all(states):
            """Full observation (incl. camera renders) of a state batch —
            only dispatched on truncation steps, for final_observation."""
            obs = jax.vmap(partial(_observe, model, cfg))(states)
            obs.update(cam_obs(states))
            return obs

        self._reset_all = reset_all
        self._step_all = step_all
        self._observe_all = observe_all
        self._states: Optional[SimState] = None
        self._steps = jnp.zeros((num_envs,), dtype=jnp.int32)

    # -- API ---------------------------------------------------------------
    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = jax.random.PRNGKey(seed)
        self._rng, sub = jax.random.split(self._rng)
        self._states, obs = self._reset_all(sub)
        self._steps = jnp.zeros((self.num_envs,), dtype=jnp.int32)
        return {n: np.asarray(v) for n, v in obs.items()}

    def step(self, actions: Dict[str, np.ndarray]):
        """actions: dict of (N, dim) arrays in the env's action space."""
        assert self._states is not None, "call reset() first"
        jactions = {
            n: jnp.asarray(v, dtype=jnp.float32).reshape(self.num_envs, -1)
            for n, v in actions.items()
        }
        self._rng, sub = jax.random.split(self._rng)
        (
            self._states, states_final, obs, reward, truncated, self._steps,
        ) = self._step_all(self._states, jactions, self._steps, sub)
        terminated = np.zeros(self.num_envs, dtype=bool)  # TimeLimit-only, like
        # the reference (SURVEY.md §3.3)
        truncated = np.asarray(truncated)
        infos: Dict = {}
        if truncated.any():
            # gymnasium 0.29 vector convention: per-env object arrays of the
            # ending episode's last obs/info, masked by "_final_observation".
            fobs = {
                n: np.asarray(v)
                for n, v in self._observe_all(states_final).items()
            }
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            for i in np.flatnonzero(truncated):
                final_obs[i] = {n: v[i] for n, v in fobs.items()}
                final_info[i] = {}
            infos = {
                "final_observation": final_obs,
                "_final_observation": truncated.copy(),
                "final_info": final_info,
                "_final_info": truncated.copy(),
            }
        return (
            {n: np.asarray(v) for n, v in obs.items()},
            np.asarray(reward),
            terminated,
            truncated,
            infos,
        )

    def close(self):
        self._states = None
