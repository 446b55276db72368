"""Parallel-in-time LQR: the Riccati backward pass as an associative scan.

This is the framework's horizon/sequence parallelism (SURVEY.md §2.4): a
serial H-step Riccati recursion has O(H) depth, which leaves the device
idle between tiny matrix ops at long horizons; reformulated with an associative
combination operator (Sarkka & Garcia-Fernandez, "Temporal Parallelization
of Bayesian Smoothers", IEEE TAC 2021 -- the LQT dual), `lax.associative_scan`
evaluates it in O(log H) depth of batched (H, n, n) matmuls.

Problem form (per step t, all arrays stacked over the horizon):
    x_{t+1} = A_t x_t + B_t u_t + d_t
    cost_t  = 1/2 x'Q x + q'x + 1/2 u'R u + r'u + u'L x
    cost_T  = 1/2 x'Qf x + qf'x

Cross/linear-in-u terms are eliminated by completing the square, the scan
runs over conditional-value-function elements (F, c, C, eta, J), and gains
are recovered per step with a vmap. `backward_sequential` is the reference
implementation used by tests and by short-horizon solves.

Both return (K, kff) with u_t = K_t x_t + kff_t optimal for the LQR.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gym_kmanip_tpu.utils.precision import highest_precision


class LQRProblem(NamedTuple):
    A: jax.Array  # (H, n, n)
    B: jax.Array  # (H, n, m)
    d: jax.Array  # (H, n)
    Q: jax.Array  # (H, n, n)
    q: jax.Array  # (H, n)
    R: jax.Array  # (H, m, m)
    r: jax.Array  # (H, m)
    L: jax.Array  # (H, m, n)  cross term u'Lx
    Qf: jax.Array  # (n, n)
    qf: jax.Array  # (n,)


def _eliminate_cross(p: LQRProblem):
    """Complete the square in u: returns (At, dt, Ct, Qt, qt, Rinv_L, Rinv_r).

    With v = u + R^{-1}(L x + r):
      cost = 1/2 x'(Q - L'R^{-1}L)x + (q - L'R^{-1}r)'x + 1/2 v'R v + const
      dyn  = (A - B R^{-1} L) x + B v + (d - B R^{-1} r)
    """
    Rinv = jnp.linalg.inv(p.R)
    Rinv_L = Rinv @ p.L  # (H, m, n)
    Rinv_r = jnp.einsum("hmn,hn->hm", Rinv, p.r)
    At = p.A - p.B @ Rinv_L
    dt = p.d - jnp.einsum("hnm,hm->hn", p.B, Rinv_r)
    Qt = p.Q - jnp.einsum("hmn,hmo->hno", p.L, Rinv_L)
    qt = p.q - jnp.einsum("hmn,hm->hn", p.L, Rinv_r)
    Ct = p.B @ Rinv @ p.B.transpose(0, 2, 1)
    return At, dt, Ct, Qt, qt, Rinv, Rinv_L, Rinv_r


@highest_precision
def backward_sequential(p: LQRProblem) -> Tuple[jax.Array, jax.Array]:
    """Reference serial Riccati sweep. Returns (K, kff), (H,m,n), (H,m)."""

    def step(carry, inp):
        P, pv = carry
        A, B, d, Q, q, R, r, L = inp
        Quu = R + B.T @ P @ B
        Qux = L + B.T @ P @ A
        Qu = r + B.T @ (P @ d + pv)
        Kk = -jnp.linalg.solve(Quu, jnp.concatenate([Qu[:, None], Qux], axis=1))
        kff, K = Kk[:, 0], Kk[:, 1:]
        P_new = Q + A.T @ P @ A + Qux.T @ K
        p_new = q + A.T @ (P @ d + pv) + Qux.T @ kff
        P_new = 0.5 * (P_new + P_new.T)
        return (P_new, p_new), (K, kff)

    (_, _), (K, kff) = jax.lax.scan(
        step, (p.Qf, p.qf), (p.A, p.B, p.d, p.Q, p.q, p.R, p.r, p.L), reverse=True
    )
    return K, kff


@highest_precision
def backward_associative(p: LQRProblem) -> Tuple[jax.Array, jax.Array]:
    """O(log H)-depth Riccati via lax.associative_scan. Returns (K, kff)."""
    H, n, _ = p.A.shape
    At, dt, Ct, Qt, qt, Rinv, Rinv_L, Rinv_r = _eliminate_cross(p)
    eye = jnp.eye(n, dtype=p.A.dtype)

    # elements for t = 0..H-1 plus the terminal element
    F = jnp.concatenate([At, jnp.zeros((1, n, n), dtype=p.A.dtype)], axis=0)
    c = jnp.concatenate([dt, jnp.zeros((1, n), dtype=p.A.dtype)], axis=0)
    C = jnp.concatenate([Ct, jnp.zeros((1, n, n), dtype=p.A.dtype)], axis=0)
    eta = jnp.concatenate([-qt, -p.qf[None]], axis=0)
    J = jnp.concatenate([Qt, p.Qf[None]], axis=0)

    def combine(later, earlier):
        # With reverse=True, lax.associative_scan feeds fn(later, earlier)
        # (verified empirically: result[t] = e_T * ... * e_t with fn(a,b)
        # composing a after b). Internally: a = earlier, b = later segment.
        Fa, ca, Ca, etaa, Ja = earlier
        Fb, cb, Cb, etab, Jb = later
        M1 = jnp.linalg.solve(
            (eye + jnp.einsum("...ij,...jk->...ik", Ca, Jb)).swapaxes(-1, -2),
            Fb.swapaxes(-1, -2),
        ).swapaxes(-1, -2)  # = Fb @ (I + Ca Jb)^{-1}
        F_ = M1 @ Fa
        c_ = jnp.einsum(
            "...ij,...j->...i", M1, ca + jnp.einsum("...ij,...j->...i", Ca, etab)
        ) + cb
        C_ = M1 @ Ca @ Fb.swapaxes(-1, -2) + Cb
        M2 = jnp.linalg.solve(
            eye + jnp.einsum("...ij,...jk->...ik", Jb, Ca),
            jnp.concatenate(
                [
                    (etab - jnp.einsum("...ij,...j->...i", Jb, ca))[..., None],
                    jnp.einsum("...ij,...jk->...ik", Jb, Fa),
                ],
                axis=-1,
            ),
        )
        eta_ = jnp.einsum("...ji,...j->...i", Fa, M2[..., 0]) + etaa
        J_ = Fa.swapaxes(-1, -2) @ M2[..., 1:] + Ja
        J_ = 0.5 * (J_ + J_.swapaxes(-1, -2))
        return (F_, c_, C_, eta_, J_)

    _, _, _, etas, Js = jax.lax.associative_scan(
        combine, (F, c, C, eta, J), reverse=True
    )
    # value function at t: V_t(x) = 1/2 x'J_t x - eta_t'x  =>  P_t = J_t,
    # p_t = -eta_t. Gains at t use (P, p) at t+1:
    P_next = Js[1:]  # (H, n, n)
    p_next = -etas[1:]  # (H, n)

    def gains(A, B, d, R, r, L, P, pv):
        Quu = R + B.T @ P @ B
        Qux = L + B.T @ P @ A
        Qu = r + B.T @ (P @ d + pv)
        Kk = -jnp.linalg.solve(Quu, jnp.concatenate([Qu[:, None], Qux], axis=1))
        return Kk[:, 1:], Kk[:, 0]

    K, kff = jax.vmap(gains)(p.A, p.B, p.d, p.R, p.r, p.L, P_next, p_next)
    return K, kff
