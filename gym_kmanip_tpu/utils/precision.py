"""The program's matmul precision.

Every float32 contraction on the dynamics, contact, kinematics, cost and
solver paths runs at HIGHEST. On a GPU the default lets XLA run f32
matmuls in TF32, which keeps about three decimal digits: the mass matrix,
the contact Jacobians and the Riccati recursion would then drift far past
the 1e-3 rad MuJoCo parity the engine is held to (tests/golden).

The entry points (`engine.substep`, `engine.control_step`,
`rollout.mpc_step`, `rollout.rollout`, `mppi.mppi_solve`, the iLQR pieces,
`parallel_lqr`, the IK solvers) trace their bodies under
`highest_precision`, so the precision is part of the lowered program
whoever jits them; tests/test_precision.py reads it there. A path may be
relaxed only with a measurement that shows the parity still holds.
"""

import functools

import jax

MATMUL_PRECISION = "highest"


def highest_precision(fn):
    """Trace `fn` with every default-precision dot at HIGHEST."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped
