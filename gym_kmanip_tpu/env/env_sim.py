"""Simulation backend: the `k_reset/k_step/k_render/k_close` protocol.

JAX analog of KManipEnvSim (/root/reference/gym_kmanip/env_sim.py:
182-211). Where the reference wraps a dm_control `control.Environment`
around native MuJoCo, this backend wraps the jitted task core
(gym_kmanip_tpu.env.task) and owns the host-side bits: episode RNG for the
cube spawn, numpy casting to the Gym dtypes, and camera rendering calls.

The k_* return tuple mirrors the reference's dm_control TimeStep unpacking
(env_base.py:222,242): (terminated, reward, discount, observation, sim_time).
"""

import time
from collections import OrderedDict as ODict
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.env.task import make_task
from gym_kmanip_tpu.render.raycast import make_render_fn


class KManipEnvSim:
    def __init__(self, gym_env):
        self.gym_env = gym_env
        cfg = gym_env.cfg
        self.cfg = cfg
        self.reset_fn, self.step_fn, self.model = make_task(cfg)
        self.state = None
        self.step_count = 0
        # per-camera jitted renderers
        self.render_fns = {}
        self._pack = None  # lazy jitted single-transfer obs packer
        for cam in gym_env.cameras:
            self.render_fns[cam.name] = make_render_fn(
                self.model, cam.name, cam.h, cam.w
            )

    # -- protocol ----------------------------------------------------------
    def k_reset(self):
        cube_pos = self.gym_env.np_random.uniform(
            k.CUBE_SPAWN_RANGE[:, 0], k.CUBE_SPAWN_RANGE[:, 1]
        )
        out = self.reset_fn(jnp.asarray(cube_pos, dtype=jnp.float32))
        self.state = out.state
        self.step_count = 0
        obs, reward, t = self._host_out(out)
        return False, reward, 1.0, obs, t

    def k_step(self, action: Dict[str, np.ndarray]):
        jaction = {
            key: jnp.asarray(np.asarray(v).reshape(-1), dtype=jnp.float32)
            for key, v in action.items()
        }
        out = self.step_fn(self.state, jaction)
        self.state = out.state
        self.step_count += 1
        obs, reward, t = self._host_out(out)
        # termination only via the gym TimeLimit wrapper, like the reference
        # (dm_control StepType trips on time limit only, SURVEY.md §3.3)
        terminated = False
        return terminated, reward, 1.0, obs, t

    def k_render(self, cam: k.Cam):
        fn = self.render_fns.get(cam.name)
        if fn is None:
            fn = make_render_fn(self.model, cam.name, cam.h, cam.w)
            self.render_fns[cam.name] = fn
        img = fn(self.state.qpos, self.state.cube_pos, self.state.cube_quat)
        return np.asarray(img)

    def k_close(self):
        self.state = None

    # -- helpers -----------------------------------------------------------
    def _host_out(self, out):
        """(obs, reward, time) on host with ONE device->host transfer for
        every state-space quantity: each sync waits for the device, and a
        per-field np.asarray pattern pays 6+ of them per step. A tiny
        jitted packer concatenates
        [obs fields..., reward, time] into one flat f32 vector, synced
        once and split on host. Camera renders (uint8 images, Vision envs
        only) remain separate transfers."""
        names = [n for n in self.gym_env.obs_list if n in out.obs]
        if self._pack is None:
            shapes = [tuple(out.obs[n].shape) for n in names]
            sizes = [int(np.prod(s)) for s in shapes]

            def pack(obs_dev, reward, t):
                parts = [
                    jnp.ravel(obs_dev[n]).astype(jnp.float32) for n in names
                ]
                parts.append(
                    jnp.stack(
                        [reward.astype(jnp.float32), t.astype(jnp.float32)]
                    )
                )
                return jnp.concatenate(parts)

            self._pack = (jax.jit(pack), shapes, sizes)
        pack_fn, shapes, sizes = self._pack
        flat = np.asarray(pack_fn(out.obs, out.reward, out.state.time))
        obs = ODict()
        off = 0
        for n, shape, size in zip(names, shapes, sizes):
            obs[n] = flat[off : off + size].reshape(shape).astype(k.OBS_DTYPE)
            off += size
        for cam in self.gym_env.cameras:
            img = self.render_fns[cam.name](
                self.state.qpos, self.state.cube_pos, self.state.cube_quat
            )
            obs[cam.log_name] = np.asarray(img)
        return obs, float(flat[-2]), float(flat[-1])


def new(gym_env) -> KManipEnvSim:
    return KManipEnvSim(gym_env)
