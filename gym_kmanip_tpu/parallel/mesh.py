"""Device mesh + sharded MPPI rollout fan-out.

The reference has zero distributed machinery (SURVEY.md §2.4); this module
is the scaling layer: a flat 1-D ('rollout',) mesh over all devices,
`shard_map` splitting the MPPI sample batch, and XLA collectives doing the
cross-device reductions (`pmin`/`psum`, which XLA hands to NCCL on GPUs --
only scalars and the (H, nu) weighted update cross devices, never rollout
trajectories). A flat mesh suits NVLink's all-to-all links.

Multi-host: call `init_distributed()` (jax.distributed.initialize) before
building the mesh; the same code then spans hosts.
"""

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gym_kmanip_tpu.dynamics.state import SimState
from gym_kmanip_tpu.models.spec import RobotModel
from gym_kmanip_tpu.mpc.mppi import MPPIConfig, MPPIState
from gym_kmanip_tpu.mpc.rollout import rollout
from gym_kmanip_tpu.utils.precision import highest_precision

ROLLOUT_AXIS = "rollout"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up (no-op when single-process)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (ROLLOUT_AXIS,))


def global_elite(costs: jax.Array, cand: jax.Array, local_k: int,
                 axis: str = ROLLOUT_AXIS) -> Tuple[jax.Array, jax.Array]:
    """Deterministic global argmin inside a shard_map region.

    Returns (best_cand, gmin): the single candidate with the globally
    minimal cost, ties broken by the smallest GLOBAL candidate index
    (device-major) — never a blend of tied candidates from different
    devices. `costs` is the (local_k,) per-device cost shard, `cand` the
    (local_k, ...) candidate shard.
    """
    gmin = jax.lax.pmin(jnp.min(costs), axis)
    local_idx = jnp.argmin(costs)  # first local minimum (deterministic)
    gidx = jax.lax.axis_index(axis) * local_k + local_idx
    gidx_masked = jnp.where(
        costs[local_idx] <= gmin, gidx, jnp.iinfo(jnp.int32).max
    )
    win_gidx = jax.lax.pmin(gidx_masked, axis)
    sel = (gidx == win_gidx).astype(cand.dtype)
    best_cand = jax.lax.psum(sel * cand[local_idx], axis)
    return best_cand, gmin


def make_sharded_ilqr_solver(
    model: RobotModel,
    cfg,
    cost_xu: Callable,
    mesh: Mesh,
    state0_template: SimState,
    batch: int,
    cost_final: Optional[Callable] = None,
    quad_xu: Optional[Callable] = None,
    quad_final: Optional[Callable] = None,
    dtype=jnp.float32,
):
    """Batched multi-problem iLQR sharded over the rollout axis (closes
    SURVEY §2.4 row 1's "MPPI/iLQR rollouts sharded across chips": the
    MPC-fleet shape — B independent problems, B/n_devices fused solves
    per chip, zero cross-chip traffic during the solve).

    Each problem gets its own flat initial state x0 and warm-start u_init;
    the SimState template supplies the shared non-solver fields (ctrl
    layout, cube fields under reduced_state, time). The per-problem math
    is the SAME compiled fused solve as make_ilqr_solver; a sharded
    batch matches the single-device solve to f32-codegen tolerance
    (tests/test_parallel.py::test_sharded_ilqr_matches_single_device —
    bitwise equality is not attainable across separately-compiled
    shard_map/jit programs of a 10-stage nonlinear solve).

    Returns a jitted solve(x0s (B, n), us (B, H, nu)) ->
    (us (B, H, nu), costs (B,), traces (B, n_iters)).
    """
    from gym_kmanip_tpu.solvers.ilqr import _build_pieces, _zero_final

    n_dev = mesh.devices.size
    assert batch % n_dev == 0, (batch, n_dev)
    if not (cfg.fused_solve and cfg.fd_linearize):
        raise ValueError(
            "sharded iLQR requires the fused single-dispatch solve "
            "(cfg.fused_solve + cfg.fd_linearize)"
        )
    cost_final_fn = cost_final if cost_final is not None else _zero_final
    pieces = _build_pieces(
        model, cfg, state0_template, cost_xu, cost_final_fn, dtype,
        quad_xu=quad_xu, quad_final=quad_final,
    )
    solve_fused = pieces[5]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(ROLLOUT_AXIS), P(ROLLOUT_AXIS)),
        out_specs=(P(ROLLOUT_AXIS), P(ROLLOUT_AXIS), P(ROLLOUT_AXIS)),
        check_vma=False,
    )
    def sharded(x0s, uss):
        from gym_kmanip_tpu.solvers.ilqr import _clip_u

        def one(x0, us):
            _xs, us_out, cost, trace = solve_fused(x0, _clip_u(model, us))
            return us_out, cost, trace

        return jax.vmap(one)(x0s, uss)

    return jax.jit(sharded)


def make_sharded_mppi_solver(
    model: RobotModel,
    cfg: MPPIConfig,
    cost_fn: Callable,
    mesh: Mesh,
):
    """Sharded MPPI solve: samples split over the rollout axis.

    cfg.n_samples must divide by mesh size. Returns a jitted function
    (MPPIState, SimState) -> (MPPIState, u0, expected_cost) whose rollouts
    run n_samples/n_devices per chip.
    """
    n_dev = mesh.devices.size
    assert cfg.n_samples % n_dev == 0, (cfg.n_samples, n_dev)
    local_k = cfg.n_samples // n_dev
    # numpy (HOST) on purpose: factory-scope DEVICE arrays captured by the
    # jitted closure become hidden executable inputs
    # (tests/test_no_device_closures.py); numpy constants are baked into
    # the HLO as literals.
    lo = model.ctrl_range[:, 0].astype(np.float32)
    hi = model.ctrl_range[:, 1].astype(np.float32)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(ROLLOUT_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,  # rollout scan carries are device-varying by design
    )
    def sharded_iter(nominal, proposal, sim_state, keys):
        # keys: (1,) per-device slice of the (n_dev,) key batch
        from gym_kmanip_tpu.mpc.mppi import sample_noise, sigma_per_actuator

        eps = sample_noise(
            keys[0], local_k, cfg.horizon, model.nu,
            sigma_per_actuator(model, cfg.sigma), cfg.noise_beta,
        )
        # device 0 reserves slot 0 for the zero-noise nominal and slot 1 for
        # the carried weighted-average proposal (see mppi.mppi_solve)
        first_dev = jax.lax.axis_index(ROLLOUT_AXIS) == 0
        eps = eps.at[0].multiply(jnp.where(first_dev, 0.0, 1.0))
        cand = jnp.clip(nominal[None] + eps, lo, hi)
        cand = cand.at[1].set(jnp.where(first_dev, proposal, cand[1]))

        def score(u_seq):
            cost, _ = rollout(
                model, sim_state, u_seq, cost_fn,
                n_substeps=cfg.n_substeps, dt=cfg.dt, contact=cfg.contact,
            )
            return cost

        costs = jax.vmap(score)(cand)  # (local_k,)
        # elite acceptance: next nominal = globally best evaluated candidate
        # (monotone since the old nominal is in the batch); averaged becomes
        # the next proposal
        best_cand, gmin = global_elite(costs, cand, local_k)
        # scale-invariant temperature via the global cost std (two psums)
        gmean = jax.lax.psum(jnp.sum(costs), ROLLOUT_AXIS) / cfg.n_samples
        gvar = jax.lax.psum(jnp.sum((costs - gmean) ** 2), ROLLOUT_AXIS) / cfg.n_samples
        lam = cfg.temperature * (jnp.sqrt(gvar) + 1e-6)
        w_un = jnp.exp(-(costs - gmin) / lam)
        z = jax.lax.psum(jnp.sum(w_un), ROLLOUT_AXIS)
        averaged = jnp.clip(
            jax.lax.psum(jnp.einsum("k,khu->hu", w_un, cand), ROLLOUT_AXIS) / z,
            lo, hi,
        )
        return best_cand, averaged, gmin

    def solve(mppi_state: MPPIState, sim_state: SimState):
        nominal, rng = mppi_state.nominal, mppi_state.rng

        def one_iter(carry, _):
            nominal, proposal, rng = carry
            rng, sub = jax.random.split(rng)
            keys = jax.random.split(sub, n_dev)
            nominal, proposal, exp_cost = sharded_iter(
                nominal, proposal, sim_state, keys
            )
            return (nominal, proposal, rng), exp_cost

        (nominal, _prop, rng), exp_costs = jax.lax.scan(
            one_iter, (nominal, nominal, rng), None, length=cfg.n_iters
        )
        u0 = nominal[0]
        shifted = jnp.concatenate([nominal[1:], nominal[-1:]], axis=0)
        return MPPIState(nominal=shifted, rng=rng), u0, exp_costs[-1]

    return jax.jit(highest_precision(solve))
