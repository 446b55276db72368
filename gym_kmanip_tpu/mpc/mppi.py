"""MPPI (model-predictive path integral) sampling MPC.

No reference analog (BASELINE north star "sampling MPC (MPPI) with
thousands of rollouts per solve"): K perturbed control sequences roll out
under `vmap` -- one big batched program where the tiny per-joint ops
become (K, ...) batched elementwise loops and GEMMs -- then the
information-theoretic weight update is two reductions, which `psum`
extends across devices (gym_kmanip_tpu.parallel).

Update rule (standard MPPI):
    w_k = softmax(-(S_k - min S) / temperature)
    U  <- U + sum_k w_k * eps_k
with per-step control clamping to the actuator ctrlrange.
"""

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_kmanip_tpu import constants as k
from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.mpc.rollout import rollout
from gym_kmanip_tpu.utils.precision import highest_precision


class MPPIConfig(NamedTuple):
    horizon: int = 50
    n_samples: int = 256
    temperature: float = 0.1
    sigma: float = 0.05  # exploration std-dev (rad) on position targets
    n_iters: int = 1  # optimization iterations per solve
    n_substeps: int = 1
    dt: float = k.CONTROL_TIMESTEP
    contact: bool = True  # False = free-space rollouts (reach-only tasks)
    # AR(1) time correlation of the exploration noise ("smooth MPPI"):
    # eps_t = beta eps_{t-1} + sqrt(1-beta^2) xi_t. White noise (beta=0)
    # jiggles the position targets incoherently -- candidates pay velocity
    # cost with no net EE displacement and reaching never improves; beta
    # ~0.8-0.95 makes candidates drift coherently
    noise_beta: float = 0.85


class MPPIState(NamedTuple):
    nominal: jax.Array  # (H, nu) current nominal control-target sequence
    rng: jax.Array


def _ar1_filter(horizon: int, beta: float) -> np.ndarray:
    """(H, H) lower-triangular AR(1) filter: eps = L @ xi.

    e_0 = xi_0 (stationary start), e_t = beta*e_{t-1} + g*xi_t, so
    L[t,0] = beta^t and L[t,s] = g*beta^(t-s) for 1 <= s <= t.
    """
    g = float(np.sqrt(1.0 - beta * beta))
    t = np.arange(horizon)
    powers = beta ** np.maximum(t[:, None] - t[None, :], 0)
    L = np.tril(g * powers)
    L[:, 0] = beta ** t
    return L.astype(np.float32)


def sample_noise(
    key: jax.Array, n_samples: int, horizon: int, nu: int,
    sigma: jax.Array, beta: float,
) -> jax.Array:
    """(K, H, nu) exploration noise, AR(1)-correlated along the horizon with
    stationary std `sigma` (per-actuator).

    The recurrence e_t = beta*e_{t-1} + g*xi_t is applied as ONE (H, H)
    lower-triangular filter matmul over the horizon axis instead of an
    H-step `lax.scan` of H sequential tiny vector ops; at HIGHEST precision
    it is exact to f32 rounding.
    """
    xi = jax.random.normal(key, (n_samples, horizon, nu), dtype=jnp.float32) * sigma
    if beta <= 0.0 or horizon == 1:
        return xi
    L = jnp.asarray(_ar1_filter(horizon, beta))
    # HIGHEST: the win is collapsing H sequential ops into one, not matmul
    # throughput — keep the filter numerically equal to the recurrence
    return jnp.einsum(
        "ts,ksu->ktu", L, xi, precision=jax.lax.Precision.HIGHEST
    )


def sigma_per_actuator(model: RobotModel, sigma: float) -> np.ndarray:
    """Exploration std per actuator: `sigma` for wide joints, scaled down to
    a quarter of the ctrlrange span for narrow ones (the gripper sliders'
    full range is 0.034 m -- uniform radian-scale noise just slams their
    limits and poisons every sample).

    Returns HOST numpy: this is config math, and a device array returned
    here would be captured by jit closures as a hidden program input
    (tests/test_no_device_closures.py). Inside traced code numpy promotes
    transparently."""
    span = (model.ctrl_range[:, 1] - model.ctrl_range[:, 0]).astype(np.float32)
    return np.minimum(np.float32(sigma), 0.25 * span)


def init_mppi(model: RobotModel, cfg: MPPIConfig, seed: int = 0) -> MPPIState:
    nominal = jnp.tile(
        jnp.asarray(model.home_qpos[: model.nu], dtype=jnp.float32), (cfg.horizon, 1)
    )
    return MPPIState(nominal=nominal, rng=jax.random.PRNGKey(seed))


@highest_precision
def mppi_solve(
    model: RobotModel,
    cfg: MPPIConfig,
    mppi_state: MPPIState,
    sim_state: SimState,
    cost_fn: Callable,
) -> Tuple[MPPIState, jax.Array, jax.Array]:
    """One MPC solve. Returns (new MPPIState, first control, expected cost).

    `cost_fn(state, aux, ctrl) -> scalar` is the running cost.
    """
    lo = jnp.asarray(model.ctrl_range[:, 0], dtype=jnp.float32)
    hi = jnp.asarray(model.ctrl_range[:, 1], dtype=jnp.float32)
    sigma = sigma_per_actuator(model, cfg.sigma)

    def one_iter(carry, _):
        nominal, proposal, rng = carry
        rng, sub = jax.random.split(rng)
        eps = sample_noise(
            sub, cfg.n_samples, cfg.horizon, model.nu, sigma, cfg.noise_beta
        )
        eps = eps.at[0].set(0.0)  # the nominal itself competes
        cand = jnp.clip(nominal[None] + eps, lo, hi)  # (K,H,nu)
        # slot 1 evaluates the weighted-average proposal carried from the
        # previous iteration -- the MPPI expectation step gets scored inside
        # the SAME batched rollout (a serial extra rollout would be pure
        # latency; this costs nothing)
        cand = cand.at[1].set(proposal)

        def score(u_seq):
            cost, _ = rollout(
                model, sim_state, u_seq, cost_fn,
                n_substeps=cfg.n_substeps, dt=cfg.dt, contact=cfg.contact,
            )
            return cost

        costs = jax.vmap(score)(cand)  # (K,)
        # scale-invariant temperature: normalize by the cost spread so the
        # softmax sharpness is independent of the cost function's units
        lam = cfg.temperature * (jnp.std(costs) + 1e-6)
        w = jax.nn.softmax(-(costs - jnp.min(costs)) / lam)
        averaged = jnp.clip(
            jnp.einsum("k,khu->hu", w, cand), lo, hi
        )
        # elite acceptance: the next nominal is the best EVALUATED sequence
        # (slot 0 is the old nominal, so this is monotone non-increasing);
        # the fresh average becomes the next iteration's proposal
        best = jnp.argmin(costs)
        return (cand[best], averaged, rng), costs[best]

    (nominal, _prop, rng), exp_costs = jax.lax.scan(
        one_iter,
        (mppi_state.nominal, mppi_state.nominal, mppi_state.rng),
        None,
        length=cfg.n_iters,
    )

    u0 = nominal[0]
    # receding horizon: shift, repeating the last target
    shifted = jnp.concatenate([nominal[1:], nominal[-1:]], axis=0)
    return MPPIState(nominal=shifted, rng=rng), u0, exp_costs[-1]


def make_mppi_solver(model: RobotModel, cfg: MPPIConfig, cost_fn: Callable):
    """Jitted single-chip solver: (MPPIState, SimState) -> (MPPIState, u0, J)."""
    return jax.jit(partial(mppi_solve, model, cfg, cost_fn=cost_fn))

