"""Gym API layer: KManipEnv.

API-parity re-implementation of the reference's env wrapper
(/root/reference/gym_kmanip/env_base.py:16-267). PROVENANCE NOTE — this
module deliberately mirrors the reference shell, and that is an explicit,
accepted design decision, not the template for any other layer:

* The ctor surface, Dict space construction, info-dict keys, and
  per-episode logger quartet (new/cam/step/end) are the COMPATIBILITY
  CONTRACT: downstream ACT/LeRobot tooling, the examples, and users'
  existing scripts read these exact names and shapes.
* The remaining implementation choices carried over — the
  `(terminated, reward, discount, observation, sim_time)` backend tuple,
  the `prefix.uuid6.date` log-dir naming — are kept ON PURPOSE so that
  recorded datasets and log trees from the two frameworks are
  byte-layout interchangeable (the h5py/rerun writers key off them).
* Everything stateful or performance-relevant lives BELOW this shell in
  the JAX core (env/task.py: one jitted decode->IK->physics->obs->
  reward program; env/vec_env.py: the batched path that skips this shell
  entirely). This file is a thin host-side adapter; no new layer should
  copy its structure.
"""

import os
import time
import uuid
from collections import OrderedDict as ODict
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional

import gymnasium as gym
import numpy as np
from gymnasium import spaces
from numpy.typing import NDArray

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.env.config import CONFIGS, EnvConfig


class KManipEnv(gym.Env):
    metadata = {"render_modes": ["rgb_array"], "render_fps": k.FPS}

    def __init__(
        self,
        seed: int = 0,
        render_mode: str = "rgb_array",
        obs_list: Optional[List[str]] = None,
        act_list: Optional[List[str]] = None,
        sim: bool = True,
        mjcf_filename: str = k.SOLO_ARM_MJCF,
        urdf_filename: str = k.SOLO_ARM_URDF,
        q_pos_home: Optional[NDArray] = None,
        q_dict: Optional[Dict[str, float]] = None,
        q_keys: Optional[List[str]] = None,
        q_id_r_mask: Optional[NDArray] = None,
        q_id_l_mask: Optional[NDArray] = None,
        ctrl_id_r_grip: Optional[NDArray] = None,
        ctrl_id_l_grip: Optional[NDArray] = None,
        log_prefix: str = "test",
        log_rerun: bool = False,
        log_h5py: bool = False,
    ):
        super().__init__()
        if obs_list is None:
            obs_list = [
                "q_pos", "q_vel", "cube_pos", "cube_orn",
                "camera/top", "camera/head", "camera/grip_l", "camera/grip_r",
            ]
        if act_list is None:
            act_list = [
                "eel_pos", "eel_orn", "eer_pos", "eer_orn",
                "grip_l", "grip_r", "q_pos",
            ]
        self.render_mode: str = render_mode
        self.seed: int = seed
        self.step_idx: int = 0
        self.episode_idx: int = 0
        self.q_pos_home: NDArray = np.asarray(q_pos_home)
        self.q_len: int = len(q_pos_home)
        self.q_dict = q_dict
        self.q_keys: List[str] = list(q_keys)
        assert len(q_keys) == self.q_len, "q parameters do not match"
        self.q_id_r_mask = q_id_r_mask
        self.q_id_l_mask = q_id_l_mask
        self.ctrl_id_r_grip = ctrl_id_r_grip
        self.ctrl_id_l_grip = ctrl_id_l_grip

        self.cameras: List[k.Cam] = []
        for obs_name in obs_list:
            if "camera" in obs_name:
                self.cameras.append(k.CAMERAS[obs_name.split("/")[-1]])

        # logging side-cars (same dynamic-import + function-quartet protocol
        # as the reference, env_base.py:93-111)
        self.log_rerun: bool = log_rerun
        self.log_h5py: bool = log_h5py
        if log_h5py or log_rerun:
            _log_dir_name = "{}.{}.{}".format(
                log_prefix, str(uuid.uuid4())[:6],
                datetime.now().strftime(k.DATE_FORMAT),
            )
            self.log_dir = os.path.join(k.DATA_DIR, _log_dir_name)
            os.makedirs(self.log_dir, exist_ok=True)
        if log_h5py:
            from gym_kmanip_tpu.log.log_h5py import new, cam, step, end

            self.log_h5py_funcs: Dict[str, Callable] = {
                "new": new, "cam": cam, "step": step, "end": end,
            }
            self.h5py_f = None
        if log_rerun:
            from gym_kmanip_tpu.log.log_rerun import new, cam, step, end

            self.log_rerun_funcs: Dict[str, Callable] = {
                "new": new, "cam": cam, "step": step, "end": end,
            }

        self.mjcf_filename: str = mjcf_filename
        self.urdf_filename: str = urdf_filename

        # observation space (env_base.py:115-155)
        self.obs_list = list(obs_list)
        _obs: "ODict[str, spaces.Space]" = ODict()
        if "q_pos" in obs_list:
            _obs["q_pos"] = spaces.Box(-1, 1, shape=(self.q_len,), dtype=k.OBS_DTYPE)
        if "q_vel" in obs_list:
            _obs["q_vel"] = spaces.Box(-1, 1, shape=(self.q_len,), dtype=k.OBS_DTYPE)
        if "cube_pos" in obs_list:
            _obs["cube_pos"] = spaces.Box(-1, 1, shape=(3,), dtype=k.OBS_DTYPE)
        if "cube_orn" in obs_list:
            _obs["cube_orn"] = spaces.Box(-1, 1, shape=(4,), dtype=k.OBS_DTYPE)
        for cam in self.cameras:
            _obs[cam.log_name] = spaces.Box(
                low=cam.low, high=cam.high, shape=(cam.h, cam.w, 3), dtype=cam.dtype
            )
        self.observation_space = spaces.Dict(_obs)

        # action space (env_base.py:157-190)
        self.act_list = list(act_list)
        _act: "ODict[str, spaces.Space]" = ODict()
        for name in ("eel_pos", "eel_orn", "eer_pos", "eer_orn"):
            if name in act_list:
                _act[name] = spaces.Box(-1, 1, shape=(3,), dtype=k.ACT_DTYPE)
        for name in ("grip_l", "grip_r"):
            if name in act_list:
                _act[name] = spaces.Box(-1, 1, shape=(1,), dtype=k.ACT_DTYPE)
        if "q_pos_r" in act_list:
            _act["q_pos_r"] = spaces.Box(
                -1, 1, shape=(len(self.q_id_r_mask),), dtype=k.ACT_DTYPE
            )
        if "q_pos_l" in act_list:
            _act["q_pos_l"] = spaces.Box(
                -1, 1, shape=(len(self.q_id_l_mask),), dtype=k.ACT_DTYPE
            )
        self.action_space = spaces.Dict(_act)
        self.action_len: int = len(self.action_space.spaces)

        # config record used by the jitted task core
        self.cfg = EnvConfig(
            env_id="custom",
            mjcf_filename=mjcf_filename,
            urdf_filename=urdf_filename,
            obs_list=tuple(self.obs_list),
            act_list=tuple(self.act_list),
            q_pos_home=self.q_pos_home,
            q_keys=tuple(self.q_keys),
            q_id_r_mask=q_id_r_mask,
            q_id_l_mask=q_id_l_mask,
            ctrl_id_r_grip=ctrl_id_r_grip,
            ctrl_id_l_grip=ctrl_id_l_grip,
        )

        self.sim: bool = sim
        if self.sim:
            from gym_kmanip_tpu.env.env_sim import new
        else:
            from gym_kmanip_tpu.env.env_real import new
        self.env = new(self)

        self.info: Dict[str, Any] = {
            "step": self.step_idx,
            "episode": self.episode_idx,
            "is_success": False,
            "q_keys": self.q_keys,
            "q_len": self.q_len,
            "a_len": self.action_len,
            "obs_list": self.obs_list,
            "act_list": self.act_list,
            "cameras": self.cameras,
            "sim": self.sim,
            # extra key (not in the reference info dict): true per-key action
            # dims so the h5py logger can size the flattened action dataset
            "act_dims": {
                name: int(np.prod(sp.shape))
                for name, sp in self.action_space.spaces.items()
            },
        }

    def render(self):
        return self.env.k_render(k.CAMERAS["top"])

    def reset(self, seed=None, options=None):
        super().reset(seed=seed)
        terminated, reward, _, observation, sim_time = self.env.k_reset()
        self.step_idx = 0
        self.episode_idx += 1
        self.info["step"] = self.step_idx
        self.info["episode"] = self.episode_idx
        self.info["sim_time"] = sim_time
        self.info["cpu_time"] = time.time()
        self.info["reward"] = reward
        self.info["is_success"] = False
        self.info["terminated"] = terminated
        if self.log_h5py:
            self.h5py_f = self.log_h5py_funcs["new"](self.log_dir, self.info)
            for cam in self.cameras:
                self.log_h5py_funcs["cam"](self.h5py_f, cam)
        if self.log_rerun:
            self.log_rerun_funcs["new"](self.log_dir, self.info)
            for cam in self.cameras:
                self.log_rerun_funcs["cam"](cam)
        return observation, self.info

    def step(self, action):
        terminated, reward, _, observation, sim_time = self.env.k_step(action)
        self.step_idx += 1
        self.info["step"] = self.step_idx
        self.info["episode"] = self.episode_idx
        self.info["sim_time"] = sim_time
        self.info["cpu_time"] = time.time()
        self.info["reward"] = reward
        self.info["is_success"] = bool(reward > k.REWARD_SUCCESS_THRESHOLD)
        self.info["terminated"] = terminated
        if self.log_rerun:
            self.log_rerun_funcs["step"](action, observation, self.info)
        if self.log_h5py:
            self.log_h5py_funcs["step"](self.h5py_f, action, observation, self.info)
        return observation, reward, terminated, False, self.info

    def close(self):
        if self.log_h5py:
            self.log_h5py_funcs["end"](self.h5py_f)
        if self.log_rerun:
            self.log_rerun_funcs["end"]()
        self.env.k_close()
        super().close()
