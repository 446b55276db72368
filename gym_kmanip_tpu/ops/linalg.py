"""Small-matrix linear algebra, unrolled for batch fusion.

The dynamics solve is (M + h B) qacc = tau with M at most 20x20. XLA's
generic `jnp.linalg.cholesky`/`cho_solve` lower to loop-based routines that
serialize badly when vmapped over thousands of MPC rollouts; here the
factorization and the two triangular solves are unrolled at trace time
(n is static), so under vmap every operation is a fused elementwise op over
the (K, ...) batch -- the "batch-fuse tiny matrices" discipline from
SURVEY.md §7 hard part 3. For nq<=20 this is ~n^3/3 scalar FLOPs per item,
all elementwise.
"""

import jax
import jax.numpy as jnp


def cholesky_factor_unrolled(M: jax.Array):
    """Trace-time-unrolled Cholesky of SPD M (..., n, n).

    Returns L as a list-of-rows of scalar (batched) entries, reusable by
    multiple `cholesky_substitute` calls (the dynamics engine factors once
    per substep and back-substitutes tau + the constraint-force
    iterations)."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for kk in range(j):
            s = s - L[j][kk] * L[j][kk]
        L[j][j] = jnp.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = M[..., i, j]
            for kk in range(j):
                s = s - L[i][kk] * L[j][kk]
            L[i][j] = s * inv_d
    return L


def cholesky_substitute(L, b: jax.Array) -> jax.Array:
    """Solve L L^T x = b given an unrolled factor from
    cholesky_factor_unrolled. b (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for kk in range(i):
            s = s - L[i][kk] * y[kk]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for kk in range(i + 1, n):
            s = s - L[kk][i] * x[kk]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def cholesky_solve_unrolled(M: jax.Array, b: jax.Array) -> jax.Array:
    """Solve M x = b for SPD M (n,n), b (n,). Unrolled Cholesky-Crout.

    Broadcasts over leading batch dims of both args.
    """
    return cholesky_substitute(cholesky_factor_unrolled(M), b)
