"""Bounded least-squares Trust-Region-Reflective solver in pure JAX.

Why this exists: the reference solves its per-step IK with
``scipy.optimize.least_squares(method='trf')``
(/root/reference/gym_kmanip/ik_mujoco.py:129-135). Matching the reference's
joint trajectories to <1e-3 rad requires matching scipy's *solutions* —
including its early ``xtol`` exits under trust-radius collapse, where a plain
LM iteration lands on a different point of the (redundant-arm) solution
manifold and the difference compounds across env steps. A fixed-budget LM
driven by the same residual/Jacobian tracks scipy to ~2e-5 per step except at
those collapse events (measured in tools/exp_ik_parity.py), so the only way
to close the gap is to reproduce the trust-region dynamics themselves.

This module is a from-scratch JAX implementation of the
Branch–Coleman–Li STIR algorithm with the same semantics as scipy's dense
path (tr_solver='exact', x_scale=1): Coleman–Li scaling, SVD-based
trust-region subproblem with Newton root-finding on the damping parameter,
reflected/truncated/gradient step selection, and scipy's exact radius-update
and termination rules. A numpy prototype of the same control flow
(tools/exp_trf_replica.py) reproduces scipy bit-for-bit on the IK problem
(status, nfev, and solutions to 2e-16 over a 20-step env-regime sequence,
including a trust-radius-collapse early exit).

Design notes: scipy's nested adaptive loops become one flat
``lax.while_loop`` whose body performs exactly one residual evaluation (one
trust-region trial). The outer-iteration bookkeeping (scaling vector, SVD,
gradient-norm termination) is recomputed every trial; on rejected trials the
inputs (x, J, g) are unchanged so the recomputation is value-identical to
scipy's cached outer state. All branches (step selection, radius update,
non-finite guard) are evaluated branchlessly and selected with ``where``,
so the whole solve is a single compiled XLA program with static shapes —
jit/vmap-safe, and cheap at IK sizes (n<=8, m<=22 plus n augmentation rows).
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gym_kmanip_tpu.utils.precision import highest_precision

_RUNNING = -1  # internal "no termination yet" status


class TRFResult(NamedTuple):
    x: jax.Array  # (n,) solution
    cost: jax.Array  # () 0.5 * |f|^2 at x
    status: jax.Array  # () int: 0 max_nfev, 1 gtol, 2 ftol, 3 xtol, 4 both
    nfev: jax.Array  # () int residual evaluations
    x_last_eval: jax.Array  # (n,) the LAST point the residual was evaluated
    # at — normally == x, but a rejected final trial (xtol exit under
    # trust-radius collapse) leaves it at the rejected point. The reference's
    # ik_res scribbles this point into live physics.data.qpos
    # (ik_mujoco.py:33-34) and never restores it, so env parity needs it.


def _norm(x):
    return jnp.sqrt(jnp.sum(x * x))


def _cl_scaling(x, g, lb, ub):
    """Coleman-Li scaling vector v and its derivative dv."""
    m1 = g < 0
    m2 = g > 0
    v = jnp.where(m1, ub - x, jnp.where(m2, x - lb, 1.0))
    dv = jnp.where(m1, -1.0, jnp.where(m2, 1.0, 0.0))
    return v, dv


def _find_active(x, lb, ub, rtol):
    """Active-constraint mask: -1 at lower, +1 at upper, 0 free."""
    if rtol == 0:
        return jnp.where(x <= lb, -1, jnp.where(x >= ub, 1, 0))
    lower_dist = x - lb
    upper_dist = ub - x
    lower_thr = rtol * jnp.maximum(1.0, jnp.abs(lb))
    upper_thr = rtol * jnp.maximum(1.0, jnp.abs(ub))
    la = lower_dist <= jnp.minimum(upper_dist, lower_thr)
    ua = upper_dist <= jnp.minimum(lower_dist, upper_thr)
    return jnp.where(la, -1, jnp.where(ua, 1, 0))


def _strictly_feasible(x, lb, ub, rstep):
    active = _find_active(x, lb, ub, rstep)
    if rstep == 0:
        x_new = jnp.where(
            active == -1,
            jnp.nextafter(lb, ub),
            jnp.where(active == 1, jnp.nextafter(ub, lb), x),
        )
    else:
        x_new = jnp.where(
            active == -1,
            lb + rstep * jnp.maximum(1.0, jnp.abs(lb)),
            jnp.where(active == 1, ub - rstep * jnp.maximum(1.0, jnp.abs(ub)), x),
        )
    tight = (x_new < lb) | (x_new > ub)
    return jnp.where(tight, 0.5 * (lb + ub), x_new)


def _step_size_to_bound(x, s, lb, ub):
    """Largest stride t>=0 with x+t*s in bounds, plus the hit mask."""
    nz = s != 0
    s_safe = jnp.where(nz, s, 1.0)
    steps = jnp.where(nz, jnp.maximum((lb - x) / s_safe, (ub - x) / s_safe), jnp.inf)
    min_step = jnp.min(steps)
    hits = (steps == min_step) & nz
    return min_step, hits


def _intersect_trust_region(x, s, Delta):
    """Both roots t of |x + t*s| = Delta (t1 <= t2)."""
    a = jnp.dot(s, s)
    b = jnp.dot(x, s)
    c = jnp.dot(x, x) - Delta * Delta
    a_safe = jnp.where(a > 0, a, 1.0)
    d = jnp.sqrt(jnp.maximum(b * b - a * c, 0.0))
    q = -(b + jnp.sign(b) * d + jnp.where(b == 0, d, 0.0))
    q_safe = jnp.where(q != 0, q, 1.0)
    t1 = q / a_safe
    t2 = jnp.where(q != 0, c / q_safe, 0.0)
    return jnp.minimum(t1, t2), jnp.maximum(t1, t2)


def _build_quadratic_1d(J, g, s, diag, s0=None):
    """psi(t) = 0.5*|J(s0+t*s)|^2 + g.(s0+t*s) (+ 0.5*diag term) coeffs."""
    v = J @ s
    a = 0.5 * (jnp.dot(v, v) + jnp.dot(s * diag, s))
    b = jnp.dot(g, s)
    if s0 is None:
        return a, b
    u = J @ s0
    b = b + jnp.dot(u, v) + jnp.dot(s0 * diag, s)
    c = 0.5 * jnp.dot(u, u) + jnp.dot(g, s0) + 0.5 * jnp.dot(s0 * diag, s0)
    return a, b, c


def _minimize_quadratic_1d(a, b, lb, ub, c=0.0):
    a_safe = jnp.where(a != 0, a, 1.0)
    ext = -0.5 * b / a_safe
    use_ext = (a != 0) & (lb < ext) & (ext < ub)
    ts = jnp.stack([lb, ub, jnp.where(use_ext, ext, lb)])
    ys = ts * (a * ts + b) + c
    i = jnp.argmin(ys)
    return ts[i], ys[i]


def _evaluate_quadratic(J, g, s, diag):
    Js = J @ s
    return 0.5 * (jnp.dot(Js, Js) + jnp.dot(s * diag, s)) + jnp.dot(s, g)


def _update_tr_radius(Delta, actual, predicted, step_norm, bound_hit):
    ratio = jnp.where(
        predicted > 0,
        actual / jnp.where(predicted > 0, predicted, 1.0),
        jnp.where((predicted == 0) & (actual == 0), 1.0, 0.0),
    )
    Delta_new = jnp.where(
        ratio < 0.25,
        0.25 * step_norm,
        jnp.where((ratio > 0.75) & bound_hit, Delta * 2.0, Delta),
    )
    return Delta_new, ratio


def _check_termination(dF, F, dx_norm, x_norm, ratio, ftol, xtol):
    ftol_ok = (dF < ftol * F) & (ratio > 0.25)
    xtol_ok = dx_norm < xtol * (xtol + x_norm)
    return jnp.where(
        ftol_ok & xtol_ok,
        4,
        jnp.where(ftol_ok, 2, jnp.where(xtol_ok, 3, _RUNNING)),
    ).astype(jnp.int32)


def _solve_lsq_trust_region(m, n, uf, s, V, Delta, initial_alpha, eps,
                            rtol=0.01, max_iter=10):
    """Min-norm-style solve of min |J_aug p + f_aug| s.t. |p| <= Delta via the
    SVD, Newton-iterating on the LM damping alpha (scipy's 'exact' tr_solver).
    m/n are the ORIGINAL residual/parameter counts (scipy passes them, not the
    augmented row count, into its threshold rule)."""
    suf = s * uf

    def phi_and_derivative(alpha):
        denom = s * s + alpha
        denom = jnp.where(denom > 0, denom, 1.0)
        q = suf / denom
        p_norm = _norm(q)
        p_norm_safe = jnp.where(p_norm > 0, p_norm, 1.0)
        phi = p_norm - Delta
        phi_prime = -jnp.sum(suf * suf / denom**3) / p_norm_safe
        phi_prime = jnp.where(phi_prime < 0, phi_prime, -jnp.finfo(s.dtype).tiny)
        return phi, phi_prime

    if m >= n:
        threshold = eps * m * s[0]
        full_rank = s[-1] > threshold
    else:
        full_rank = jnp.asarray(False)

    s_safe = jnp.where(s > 0, s, 1.0)
    p_newton = -(V @ (uf / s_safe))
    interior = full_rank & (_norm(p_newton) <= Delta)

    alpha_upper = _norm(suf) / Delta
    phi0, phip0 = phi_and_derivative(jnp.zeros((), s.dtype))
    alpha_lower = jnp.where(full_rank, -phi0 / phip0, 0.0)

    alpha = jnp.where(
        (~full_rank) & (initial_alpha == 0),
        jnp.maximum(0.001 * alpha_upper, jnp.sqrt(alpha_lower * alpha_upper)),
        initial_alpha,
    )

    def body(_, carry):
        alpha, al, au, done = carry
        alpha_adj = jnp.where(
            (alpha < al) | (alpha > au),
            jnp.maximum(0.001 * au, jnp.sqrt(al * au)),
            alpha,
        )
        phi, phip = phi_and_derivative(alpha_adj)
        au_new = jnp.where(phi < 0, alpha_adj, au)
        ratio = phi / phip
        al_new = jnp.maximum(al, alpha_adj - ratio)
        alpha_new = alpha_adj - (phi + Delta) * ratio / Delta
        done_new = done | (jnp.abs(phi) < rtol * Delta)
        alpha = jnp.where(done, alpha, alpha_new)
        al = jnp.where(done, al, al_new)
        au = jnp.where(done, au, au_new)
        return alpha, al, au, done_new

    alpha, _, _, _ = jax.lax.fori_loop(
        0, max_iter, body, (alpha, alpha_lower, alpha_upper, jnp.asarray(False))
    )

    denom = s * s + alpha
    denom = jnp.where(denom > 0, denom, 1.0)
    p_raw = -(V @ (suf / denom))
    pn = _norm(p_raw)
    p_damped = p_raw * (Delta / jnp.where(pn > 0, pn, 1.0))

    p = jnp.where(interior, p_newton, p_damped)
    alpha_out = jnp.where(interior, 0.0, alpha)
    return p, alpha_out


def _select_step(x, J_h, diag_h, g_h, p, p_h, d, Delta, lb, ub, theta):
    """STIR step selection: full TR step if interior, else best of the
    truncated step, its bound-reflection, and the projected scaled gradient."""
    inb = jnp.all((x + p >= lb) & (x + p <= ub))
    p_value_full = _evaluate_quadratic(J_h, g_h, p_h, diag_h)

    p_stride, hits = _step_size_to_bound(x, p, lb, ub)
    r_h = jnp.where(hits, -p_h, p_h)
    r = d * r_h

    p_tr = p * p_stride
    p_h_tr = p_h * p_stride
    x_on_bound = x + p_tr

    _, to_tr = _intersect_trust_region(p_h_tr, r_h, Delta)
    to_bound, _ = _step_size_to_bound(x_on_bound, r, lb, ub)

    r_stride = jnp.minimum(to_bound, to_tr)
    pos = r_stride > 0
    r_stride_safe = jnp.where(pos, r_stride, 1.0)
    r_stride_l = jnp.where(pos, (1 - theta) * p_stride / r_stride_safe, 0.0)
    r_stride_u = jnp.where(
        pos, jnp.where(r_stride == to_bound, theta * to_bound, to_tr), -1.0
    )
    valid_r = r_stride_l <= r_stride_u

    a, b, c = _build_quadratic_1d(J_h, g_h, r_h, diag_h, s0=p_h_tr)
    r_stride_min, r_value = _minimize_quadratic_1d(
        a, b, r_stride_l, jnp.where(valid_r, r_stride_u, r_stride_l), c
    )
    r_h_final = r_h * r_stride_min + p_h_tr
    r_final = r_h_final * d
    r_value = jnp.where(valid_r, r_value, jnp.inf)

    p_theta = p * theta
    p_h_theta = p_h * theta
    p_value = _evaluate_quadratic(J_h, g_h, p_h_theta, diag_h)

    ag_h = -g_h
    ag = d * ag_h
    ag_h_norm = _norm(ag_h)
    to_tr_g = Delta / jnp.where(ag_h_norm > 0, ag_h_norm, 1.0)
    to_bound_g, _ = _step_size_to_bound(x, ag, lb, ub)
    ag_stride_max = jnp.where(to_bound_g < to_tr_g, theta * to_bound_g, to_tr_g)
    a2, b2 = _build_quadratic_1d(J_h, g_h, ag_h, diag_h)
    ag_stride, ag_value = _minimize_quadratic_1d(
        a2, b2, jnp.zeros((), x.dtype), ag_stride_max
    )
    ag_h_final = ag_h * ag_stride
    ag_final = ag * ag_stride

    use_p = (p_value < r_value) & (p_value < ag_value)
    use_r = (r_value < p_value) & (r_value < ag_value)

    def pick(cp, cr, cag):
        return jnp.where(use_p, cp, jnp.where(use_r, cr, cag))

    step = pick(p_theta, r_final, ag_final)
    step_h = pick(p_h_theta, r_h_final, ag_h_final)
    value = pick(p_value, r_value, ag_value)

    step = jnp.where(inb, p, step)
    step_h = jnp.where(inb, p_h, step_h)
    value = jnp.where(inb, p_value_full, value)
    return step, step_h, -value


class _State(NamedTuple):
    x: jax.Array
    f: jax.Array
    cost: jax.Array
    J: jax.Array
    g: jax.Array
    Delta: jax.Array
    alpha: jax.Array
    nfev: jax.Array
    status: jax.Array
    x_last: jax.Array


@highest_precision
def least_squares_trf(
    res_fn: Callable[[jax.Array], jax.Array],
    jac_fn: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    lb: jax.Array,
    ub: jax.Array,
    *,
    ftol: float = 1e-8,
    xtol: float = 1e-8,
    gtol: float = 1e-8,
    max_nfev: int | None = None,
) -> TRFResult:
    """scipy.optimize.least_squares(method='trf') semantics in one jittable
    while_loop. Defaults mirror scipy's (ik_mujoco.py passes none)."""
    dtype = x0.dtype
    n = x0.shape[0]
    f_probe = jax.eval_shape(res_fn, x0)
    m = f_probe.shape[0]
    eps = jnp.finfo(dtype).eps
    if max_nfev is None:
        max_nfev = 100 * n

    lb = jnp.asarray(lb, dtype)
    ub = jnp.asarray(ub, dtype)

    x_init = _strictly_feasible(jnp.asarray(x0, dtype), lb, ub, 1e-10)
    f_init = res_fn(x_init)
    J_init = jac_fn(x_init)
    cost_init = 0.5 * jnp.dot(f_init, f_init)
    g_init = J_init.T @ f_init
    v0, _ = _cl_scaling(x_init, g_init, lb, ub)
    Delta_init = _norm(x_init / jnp.sqrt(v0))
    Delta_init = jnp.where(Delta_init == 0, 1.0, Delta_init)

    init = _State(
        x=x_init,
        f=f_init,
        cost=cost_init,
        J=J_init,
        g=g_init,
        Delta=Delta_init,
        alpha=jnp.zeros((), dtype),
        nfev=jnp.asarray(1, jnp.int32),
        status=jnp.asarray(_RUNNING, jnp.int32),
        x_last=x_init,
    )

    def cond(s: _State):
        return (s.status == _RUNNING) & (s.nfev < max_nfev)

    def trial(s: _State) -> _State:
        v, dv = _cl_scaling(s.x, s.g, lb, ub)
        g_norm = jnp.max(jnp.abs(s.g * v))

        d = jnp.sqrt(v)
        diag_h = s.g * dv
        g_h = d * s.g
        J_h = s.J * d[None, :]
        J_aug = jnp.concatenate([J_h, jnp.diag(jnp.sqrt(diag_h))], axis=0)
        U, sv, Vt = jnp.linalg.svd(J_aug, full_matrices=False)
        V = Vt.T
        uf = U[:m].T @ s.f
        theta = jnp.maximum(0.995, 1 - g_norm)

        p_h, alpha_new = _solve_lsq_trust_region(
            m, n, uf, sv, V, s.Delta, s.alpha, eps
        )
        p = d * p_h
        step, step_h, pred_red = _select_step(
            s.x, J_h, diag_h, g_h, p, p_h, d, s.Delta, lb, ub, theta
        )
        x_new = _strictly_feasible(s.x + step, lb, ub, 0)
        f_new = res_fn(x_new)
        nfev = s.nfev + 1
        step_h_norm = _norm(step_h)
        finite = jnp.all(jnp.isfinite(f_new))
        cost_new = 0.5 * jnp.dot(f_new, f_new)
        actual_red = s.cost - cost_new
        Delta_upd, ratio = _update_tr_radius(
            s.Delta, actual_red, pred_red, step_h_norm, step_h_norm > 0.95 * s.Delta
        )
        term = _check_termination(
            actual_red, s.cost, _norm(step), _norm(s.x), ratio, ftol, xtol
        )
        term = jnp.where(finite, term, _RUNNING)
        # gtol fires at the top of scipy's outer loop, i.e. before this trial:
        # it wins over any same-trial termination and discards the trial eval.
        gtol_hit = g_norm < gtol
        status = jnp.where(gtol_hit, 1, term).astype(jnp.int32)

        terminated = status != _RUNNING
        accept = (~gtol_hit) & finite & (actual_red > 0)

        Delta_next = jnp.where(
            finite & ~terminated, Delta_upd, jnp.where(finite, s.Delta, 0.25 * step_h_norm)
        )
        alpha_next = jnp.where(
            finite & ~terminated,
            alpha_new * (s.Delta / jnp.where(Delta_upd > 0, Delta_upd, 1.0)),
            alpha_new,
        )
        alpha_next = jnp.where(gtol_hit, s.alpha, alpha_next)
        nfev = jnp.where(gtol_hit, s.nfev, nfev)
        # scipy stops BEFORE this trial on gtol, so its residual was never
        # evaluated there — keep the previous scribble point in that case
        x_last = jnp.where(gtol_hit, s.x_last, x_new)

        x_acc = jnp.where(accept, x_new, s.x)
        f_acc = jnp.where(accept, f_new, s.f)
        cost_acc = jnp.where(accept, cost_new, s.cost)
        J_acc = jax.lax.cond(accept, lambda: jac_fn(x_new), lambda: s.J)
        g_acc = J_acc.T @ f_acc

        return _State(
            x=x_acc,
            f=f_acc,
            cost=cost_acc,
            J=J_acc,
            g=g_acc,
            Delta=Delta_next,
            alpha=alpha_next,
            nfev=nfev,
            status=status,
            x_last=x_last,
        )

    out = jax.lax.while_loop(cond, trial, init)
    status = jnp.where(out.status == _RUNNING, 0, out.status)
    return TRFResult(
        x=out.x, cost=out.cost, status=status, nfev=out.nfev, x_last_eval=out.x_last
    )
