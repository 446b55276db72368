"""gym_kmanip_tpu: JAX manipulation suite for the K-Scale Stompy robots.

A JAX/XLA framework with the capabilities of the reference gym-kmanip
suite (Gymnasium + MuJoCo, see SURVEY.md): three robot morphologies, eight
registered environments, cube-pick task with shaped reward, damped
least-squares IK, camera rendering, HDF5 + viz episode logging -- plus
batched dynamics, sampling/iLQR MPC and multi-device rollout sharding.

When gymnasium is installed, importing this package registers the same 8
env ids as the reference (/root/reference/gym_kmanip/__init__.py:244-483):
KManipSoloArm[QPos|Vision], KManipDualArm[QPos|Vision], KManipTorso[Vision].
The dynamics, MPC and solver modules need only JAX and numpy.
"""

from gym_kmanip_tpu import constants
from gym_kmanip_tpu.constants import *  # noqa: F401,F403 -- k.* constant surface
from gym_kmanip_tpu.env.config import CONFIGS

__version__ = "0.1.0"

try:
    from gymnasium.envs.registration import register
except ImportError:  # the Gym shell is optional; the engine is not
    register = None

for _cfg in CONFIGS.values() if register is not None else ():
    register(
        id=_cfg.env_id,
        entry_point="gym_kmanip_tpu.env.env_base:KManipEnv",
        max_episode_steps=_cfg.max_episode_steps,
        nondeterministic=True,
        kwargs={
            "mjcf_filename": _cfg.mjcf_filename,
            "urdf_filename": _cfg.urdf_filename,
            "obs_list": list(_cfg.obs_list),
            "act_list": list(_cfg.act_list),
            "q_pos_home": _cfg.q_pos_home,
            "q_dict": {key: float(v) for key, v in zip(_cfg.q_keys, _cfg.q_pos_home)},
            "q_keys": list(_cfg.q_keys),
            "q_id_r_mask": _cfg.q_id_r_mask,
            "q_id_l_mask": _cfg.q_id_l_mask,
            "ctrl_id_r_grip": _cfg.ctrl_id_r_grip,
            "ctrl_id_l_grip": _cfg.ctrl_id_l_grip,
        },
    )
