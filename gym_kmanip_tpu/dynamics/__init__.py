"""Batched articulated dynamics in pure JAX (MJX-style).

JAX replacement for the reference's native MuJoCo step pipeline
(`mj_step` reached through dm_control at
/root/reference/gym_kmanip/env_sim.py:196-210: 10 substeps of 2 ms per 20 ms
control step).
"""

from gym_kmanip_tpu.dynamics.state import SimState, StepAux, init_state
from gym_kmanip_tpu.dynamics.engine import (
    control_step,
    make_control_step,
    substep,
)

__all__ = [
    "SimState",
    "StepAux",
    "init_state",
    "control_step",
    "make_control_step",
    "substep",
]
