"""Batched closed-form small-matrix algebra and Gaussian distances.

Array-program equivalent of the reference's device math library
(``src/device_math.cuh``): everything here is a pure function over
arbitrarily-batched arrays whose *trailing* dims are the matrix dims, so the
same code serves scalar use, vmap over features, and [P, F, ...] batches.

Semantics parity notes (all vs /root/reference/src/device_math.cuh):
 - ``safe_log``      — src/device_math.cuh:9-16 (log(x) if x>0 else -FLT_MAX)
 - ``wrap_angle``    — src/device_math.cuh:242-251 (fmod then fold to [-pi,pi])
 - ``det2/inv2``     — src/device_math.cuh:36-38,61-70
 - ``mahalanobis``   — src/device_math.cuh:309-363 (avg-cov symmetrized form)
 - ``hellinger``     — src/device_math.cuh:365-413
 - ``logistic``      — src/device_math.cuh:19-24
"""

from __future__ import annotations

import jax.numpy as jnp

from phdslam_tpu.config import LOG0


def safe_log(x):
    """NaN-safe log: log(x) for x>0, LOG0 (== -FLT_MAX) otherwise."""
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, 1e-38)), LOG0)


def logistic(x, lower, upper, beta, tau):
    """Generalized logistic, (upper-lower)/(1+exp(-beta*(x-tau)))."""
    return (upper - lower) / (1.0 + jnp.exp(-beta * (x - tau)))


def wrap_angle(a):
    """Wrap angle to [-pi, pi] with the reference's fmod-then-fold rule."""
    two_pi = 2.0 * jnp.pi
    r = jnp.fmod(a, two_pi)  # same sign as a, in (-2pi, 2pi)
    r = jnp.where(r > jnp.pi, r - two_pi, r)
    r = jnp.where(r < -jnp.pi, r + two_pi, r)
    return r


# ---------------------------------------------------------------------------
# 2x2 block algebra on [..., 2, 2] arrays
# ---------------------------------------------------------------------------

def det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m, det=None):
    """Closed-form 2x2 inverse. Pass a precomputed determinant to share it."""
    d = det2(m) if det is None else det
    inv = jnp.stack(
        [
            jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
            jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / d[..., None, None]


def sym2(m):
    """Force symmetry of a 2x2 by averaging the off-diagonals
    (the reference's explicit `(sigma[1]+sigma[2])/2`)."""
    off = 0.5 * (m[..., 0, 1] + m[..., 1, 0])
    return jnp.stack(
        [
            jnp.stack([m[..., 0, 0], off], axis=-1),
            jnp.stack([off, m[..., 1, 1]], axis=-1),
        ],
        axis=-2,
    )


def symmetrize(m):
    """Force symmetry of an [..., d, d] matrix: (M + M^T)/2."""
    return 0.5 * (m + jnp.swapaxes(m, -1, -2))


def quadform(x, A):
    """x^T A x for [..., d] vectors and [..., d, d] matrices."""
    return jnp.einsum("...i,...ij,...j->...", x, A, x)


# ---------------------------------------------------------------------------
# Gaussian distances (batched over leading dims)
# ---------------------------------------------------------------------------

def mahalanobis_gaussian(mean_a, cov_a, mean_b, cov_b):
    """Squared Mahalanobis distance with the averaged covariance
    0.5*(cov_a+cov_b), as the merge kernel uses (src/device_math.cuh:309-330).

    Works for any trailing dim d via explicit solve; for d==2 uses the
    closed-form inverse to match reference arithmetic exactly.
    """
    d = mean_a.shape[-1]
    diff = mean_a - mean_b
    sigma = 0.5 * (cov_a + cov_b)
    if d == 2:
        si = inv2(sigma)
        return quadform(diff, si)
    sol = jnp.linalg.solve(sigma, diff[..., None])[..., 0]
    return jnp.sum(diff * sol, axis=-1)


def hellinger_gaussian(mean_a, cov_a, mean_b, cov_b):
    """Hellinger-style distance per src/device_math.cuh:388-413 (2-D only in
    the reference; generalized via dets here). Returns
    1 - sqrt( sqrt(det(Sa*Sb)) / det((Sa+Sb)/4) ... ) * exp(-1/4 * d^T (Sa+Sb)^-1 d)
    following the reference arithmetic exactly.
    """
    diff = mean_a - mean_b
    sigma_sum = cov_a + cov_b
    det_sum = jnp.linalg.det(sigma_sum)
    # reference guards: if det <= FLT_MIN use identity inverse
    use_inv = det_sum > 1.17549435e-38
    if mean_a.shape[-1] == 2:
        inv_sum = jnp.where(use_inv[..., None, None], inv2(sigma_sum),
                            jnp.eye(2, dtype=sigma_sum.dtype))
    else:
        eye = jnp.eye(mean_a.shape[-1], dtype=sigma_sum.dtype)
        inv_sum = jnp.where(use_inv[..., None, None],
                            jnp.linalg.inv(sigma_sum), eye)
    epsilon = -0.25 * quadform(diff, inv_sum)
    det_quarter = det_sum / (2.0 ** mean_a.shape[-1])  # det(S/2) for d dims
    det_prod = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", cov_a, cov_b))
    dist = jnp.sqrt(det_prod) / det_quarter
    return 1.0 - jnp.sqrt(dist) * jnp.exp(epsilon)


def gaussian_logpdf(x, mean, cov):
    """log N(x; mean, cov) for [..., d]; closed-form for d==2."""
    d = x.shape[-1]
    diff = x - mean
    if d == 2:
        det = det2(cov)
        si = inv2(cov, det)
        maha = quadform(diff, si)
        return -0.5 * maha - 0.5 * jnp.log(
            (2.0 * jnp.pi) ** d * jnp.maximum(det, 1e-38))
    sign, logdet = jnp.linalg.slogdet(cov)
    sol = jnp.linalg.solve(cov, diff[..., None])[..., 0]
    maha = jnp.sum(diff * sol, axis=-1)
    return -0.5 * (maha + d * jnp.log(2.0 * jnp.pi) + logdet)
