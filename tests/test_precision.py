"""The program's stated matmul precision and the float32 error it buys.

Every float32 contraction on the dynamics, cost and solver paths runs at
HIGHEST (utils/precision.py). These tests hold the code to it where it
shows, in the lowered program, and measure what float32 costs against a
float64 evaluation of the same code. chip_smoke.py compares the GPU with
the CPU at twice these bounds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_kmanip_tpu.dynamics.engine import substep
from gym_kmanip_tpu.models import get_model

# float32 vs float64 of the same substep (2 ms explicit, contact active):
# measured max abs errors on the CPU are ~2e-7 in positions and ~2.4e-5 in
# velocities (dual_arm), so these bounds hold with margin
F64_ATOL = {"qpos": 1e-5, "cube_pos": 1e-5, "cube_quat": 1e-5,
            "qvel": 1e-4, "cube_linvel": 1e-4, "cube_angvel": 1e-4}
F64_RTOL = 1e-4


def _chip_smoke():
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return importlib.import_module("chip_smoke")


def _as(states, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), states)


@pytest.mark.parametrize("name", ["solo_arm", "dual_arm", "torso"])
def test_batched_substep_matches_float64(name):
    """vmap(substep) in float32 against the same jnp code in float64, on
    the batch chip_smoke uses (half the cubes against a fingertip)."""
    model = get_model(name)
    states = _chip_smoke()._batch_states(model, 4, seed=len(name))

    def step(s):
        return substep(model, s, 0.002, contact=True)

    out32, (touch, _, _) = jax.jit(jax.vmap(step))(states)
    with jax.enable_x64(True):
        out64, _ = jax.jit(jax.vmap(step))(_as(states, np.float64))
        assert np.asarray(out64.qpos).dtype == np.float64
        out64 = jax.tree.map(np.asarray, out64)
    assert int(np.asarray(touch).sum()) > 0  # contact is exercised
    for field, atol in F64_ATOL.items():
        np.testing.assert_allclose(
            np.asarray(getattr(out32, field)), getattr(out64, field),
            atol=atol, rtol=F64_RTOL, err_msg=field,
        )


def _riccati_numpy(A, B, cx, cu, cxx, cuu, cux, VxT, VxxT, reg):
    """The serial sweep's recursion in float64 numpy."""
    H, n, m = B.shape
    Vx, Vxx = VxT, VxxT
    ks, Ks = np.zeros((H, m)), np.zeros((H, m, n))
    for t in range(H - 1, -1, -1):
        Qx = cx[t] + A[t].T @ Vx
        Qu = cu[t] + B[t].T @ Vx
        Qxx = cxx[t] + A[t].T @ Vxx @ A[t]
        Quu = cuu[t] + B[t].T @ Vxx @ B[t] + reg * np.eye(m)
        Qux = cux[t] + B[t].T @ Vxx @ A[t]
        Quu = 0.5 * (Quu + Quu.T)
        Kk = -np.linalg.solve(Quu, np.concatenate([Qu[:, None], Qux], axis=1))
        ks[t], Ks[t] = Kk[:, 0], Kk[:, 1:]
        Vx = Qx + Ks[t].T @ Quu @ ks[t] + Ks[t].T @ Qu + Qux.T @ ks[t]
        Vxx = Qxx + Ks[t].T @ Quu @ Ks[t] + Ks[t].T @ Qux + Qux.T @ Ks[t]
        Vxx = 0.5 * (Vxx + Vxx.T)
    return ks, Ks


def test_riccati_scan_matches_float64_at_torso_widths():
    """The iLQR serial backward sweep (lax.scan) in float32 against a
    float64 numpy recursion, at the torso's reduced-state widths (n=40,
    m=20) on a well-conditioned problem."""
    from gym_kmanip_tpu.solvers.ilqr import riccati_sweep

    rng = np.random.RandomState(0)
    H, n, m = 12, 40, 20
    A = 0.05 * rng.randn(H, n, n) + 0.95 * np.eye(n)
    B = 0.1 * rng.randn(H, n, m)
    W = rng.randn(H, n, n) / np.sqrt(n)
    cxx = W @ W.transpose(0, 2, 1) + np.eye(n)
    Wu = rng.randn(H, m, m) / np.sqrt(m)
    cuu = Wu @ Wu.transpose(0, 2, 1) + np.eye(m)
    cx, cu = rng.randn(H, n), rng.randn(H, m)
    cux = 0.05 * rng.randn(H, m, n)
    Wt = rng.randn(n, n) / np.sqrt(n)
    VxT, VxxT = rng.randn(n), Wt @ Wt.T + np.eye(n)
    args = (A, B, cx, cu, cxx, cuu, cux, VxT, VxxT)

    ks_ref, Ks_ref = _riccati_numpy(*args, reg=1e-6)
    f32 = [jnp.asarray(a, jnp.float32) for a in args]
    ks, Ks = jax.jit(riccati_sweep)(*f32, 1e-6, jnp.float32(0.0))
    scale_k, scale_K = np.abs(ks_ref).max(), np.abs(Ks_ref).max()
    np.testing.assert_allclose(np.asarray(ks), ks_ref, atol=1e-4 * scale_k)
    np.testing.assert_allclose(np.asarray(Ks), Ks_ref, atol=1e-4 * scale_K)


def _dot_precisions(lowered):
    lines = [l for l in lowered.as_text().splitlines() if "dot_general" in l]
    return [re.search(r"precision = \[([A-Z_, ]+)\]", l) for l in lines]


def _assert_all_highest(lowered):
    found = _dot_precisions(lowered)
    assert found, "no dot_general in the lowered program"
    bad = [m.group(1) if m else "unset" for m in found
           if not m or m.group(1) != "HIGHEST, HIGHEST"]
    assert not bad, f"{len(bad)}/{len(found)} dot_generals not at HIGHEST: {bad[:3]}"


def _lower_substep():
    model = get_model("torso")
    states = _chip_smoke()._batch_states(model, 2, seed=0)
    return jax.jit(jax.vmap(
        lambda s: substep(model, s, 0.02, contact=True, implicit_actuation=True)
    )).lower(states)


def _lower_mppi():
    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver

    model = get_model("solo_arm")
    params = CostParams()
    cost_fn = lambda s, aux, u: cube_pick_cost(model, s, aux, u, params)
    cfg = MPPIConfig(horizon=3, n_samples=4, n_iters=1)
    solver = make_mppi_solver(model, cfg, cost_fn)
    return solver.lower(init_mppi(model, cfg), init_state(model))


def _lower_ilqr_backward():
    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.solvers.ilqr import ILQRConfig, _build_pieces, _zero_final

    model = get_model("solo_arm")
    H, n, m = 4, 2 * model.nq, model.nu
    cfg = ILQRConfig(horizon=H, n_iters=1, contact=False, reduced_state=True)
    cost_xu = lambda x, u: jnp.sum(x**2) + jnp.sum(u**2)
    backward = _build_pieces(model, cfg, init_state(model), cost_xu,
                             _zero_final, jnp.float32)[2]
    z = lambda *s: jnp.zeros(s, jnp.float32)
    return backward.lower(z(H, n, n), z(H, n, m), z(H, n), z(H, m), z(H, n, n),
                          z(H, m, m), z(H, m, n), z(n), z(n, n), jnp.float32(0.0))


@pytest.mark.parametrize("which", ["substep", "mppi_solve", "ilqr_backward"])
def test_every_dot_general_runs_at_highest(which):
    """The precision is part of the lowered program, whoever jits it: a
    float32 dot on these paths at DEFAULT would run in TF32 on a GPU."""
    lower = {"substep": _lower_substep, "mppi_solve": _lower_mppi,
             "ilqr_backward": _lower_ilqr_backward}[which]
    _assert_all_highest(lower())
