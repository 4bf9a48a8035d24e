"""Gaussian-mixture operations on fixed-shape padded arrays.

Replaces the reference's dynamic-shape mixture machinery:
 - thrust::remove_copy_if pruning (src/phdfilter.cu:3105-3174)  -> weight
   masking + weight-ranked top-k compaction,
 - the block-per-particle greedy merge kernel phdUpdateMergeKernel
   (src/phdfilter.cu:2707-2898) -> a bounded ``lax.while_loop`` vmapped over
   particles,
 - the CPU Eigen reduceGaussianMixture used for the EAP map
   (src/gm_reduce.cpp:57-134) -> the same greedy merge (both implement
   max-weight-first moment-matched clustering).

All functions are jit-safe (static shapes, no data-dependent shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phdslam_tpu.ops.linalg import (
    hellinger_gaussian,
    mahalanobis_gaussian,
    symmetrize,
)


def top_k_components(w, mean, cov, k):
    """Compact a padded mixture to its k highest-weight components.

    The fixed-shape analog of stream compaction: empty slots (w==0) sort
    last; the result is a valid padded mixture of static size k.
    w [..., N]; mean [..., N, d]; cov [..., N, d, d].
    """
    top_w, idx = jax.lax.top_k(w, k)
    mean_k = jnp.take_along_axis(mean, idx[..., None], axis=-2)
    cov_k = jnp.take_along_axis(cov, idx[..., None, None], axis=-3)
    return top_w, mean_k, cov_k


def prune_weights(w, min_weight):
    """Zero out sub-threshold weights — the merge-flag prune of
    src/phdfilter.cu:2307-2319 (weight < minFeatureWeight -> dropped)."""
    return jnp.where(w >= min_weight, w, 0.0)


def fast_prune_renormalize(w, min_weight):
    """Fast-merge pre-pass (merge_mode = 1): zero candidates below
    ``min_weight`` and scale the survivors so each row's total intensity
    mass is preserved (the classic GM-PHD prune-and-rescale; Vo & Ma 2006,
    Table II step 2 rescales exactly this way after truncation).

    Why it's fast: the greedy merge's cost is its trip count — one
    sequential pick per output cluster — and sub-threshold candidates are
    overwhelmingly singleton clusters (tiny detection terms on clutter,
    decayed non-detections). Zeroing them removes their trips; the
    renormalization keeps E[N] = sum w exact so the cardinality estimate
    (and OSPA's cardinality term) is unbiased. Deviation from the
    reference's exact greedy is documented in PARITY.md; accuracy evidence
    is the exact-vs-fast MC envelope in RESULTS.md.

    w [..., K] -> same shape.
    """
    total = jnp.sum(w, axis=-1, keepdims=True)
    kept = jnp.where(w >= min_weight, w, 0.0)
    ksum = jnp.sum(kept, axis=-1, keepdims=True)
    scale = jnp.where(ksum > 0, total / jnp.maximum(ksum, 1e-30), 0.0)
    return kept * scale


def _pairwise_dist(mean_ref, cov_ref, mean, cov, metric: int):
    if metric == 1:
        return hellinger_gaussian(mean_ref, cov_ref, mean, cov)
    return mahalanobis_gaussian(mean_ref, cov_ref, mean, cov)


def greedy_merge(w, mean, cov, min_separation, max_out: int,
                 metric: int = 0):
    """Greedy max-weight-first moment-matched mixture reduction.

    Per-particle semantics of phdUpdateMergeKernel
    (src/phdfilter.cu:2739-2890):
      while any unmerged component has weight > 0 (up to ``max_out`` rounds):
        pick the max-weight unmerged component; gather every unmerged
        component within ``min_separation`` (Mahalanobis with averaged covs,
        or Hellinger); moment-match them into one Gaussian; mark merged.

    Unbatched (single mixture); vmap over particles. Components with w == 0
    are empty. Unlike the reference (unbounded output) the output is capped
    at ``max_out`` rounds; weight-descending picking makes the dropped tail
    the least significant components.

    Returns (w_out [max_out], mean_out [max_out, d], cov_out [max_out, d, d]).
    """
    n, d = mean.shape[0], mean.shape[1]
    dtype = mean.dtype

    def body(carry):
        i, w_rem, w_out, mean_out, cov_out = carry
        # max-weight unmerged component (parallel argmax reduction analog)
        pick = jnp.argmax(w_rem)
        ref_mean = mean[pick]
        ref_cov = cov[pick]
        dist = _pairwise_dist(ref_mean[None], ref_cov[None], mean, cov, metric)
        sel = (dist < min_separation) & (w_rem > 0)
        # the picked component always merges with itself
        sel = sel.at[pick].set(True)
        sw = jnp.where(sel, w_rem, 0.0)
        wsum = jnp.sum(sw)
        mu = jnp.sum(sw[:, None] * mean, axis=0) / wsum
        diff = mu[None, :] - mean                        # [n, d]
        outer = diff[:, :, None] * diff[:, None, :]      # [n, d, d]
        sig = jnp.sum(sw[:, None, None] * (cov + outer), axis=0) / wsum
        sig = symmetrize(sig)
        w_out = w_out.at[i].set(wsum)
        mean_out = mean_out.at[i].set(mu)
        cov_out = cov_out.at[i].set(sig)
        w_rem = jnp.where(sel, 0.0, w_rem)
        return i + 1, w_rem, w_out, mean_out, cov_out

    def cond(carry):
        i, w_rem, *_ = carry
        return (i < max_out) & jnp.any(w_rem > 0)

    init = (
        jnp.array(0, jnp.int32),
        w,
        jnp.zeros((max_out,), dtype),
        jnp.zeros((max_out, d), dtype),
        jnp.broadcast_to(jnp.eye(d, dtype=dtype), (max_out, d, d)).copy(),
    )
    _, _, w_out, mean_out, cov_out = jax.lax.while_loop(cond, body, init)
    return w_out, mean_out, cov_out


def greedy_merge_batch(w, mean, cov, min_separation, max_out: int,
                       metric: int = 0):
    """Batched greedy merge (array-of-structs API over the channel core)."""
    mx, my = mean[..., 0], mean[..., 1]
    c00 = cov[..., 0, 0]
    c01 = 0.5 * (cov[..., 0, 1] + cov[..., 1, 0])
    c11 = cov[..., 1, 1]
    ow, omx, omy, o00, o01, o11 = greedy_merge_channels(
        w, mx, my, c00, c01, c11, min_separation, max_out, metric)
    mean_out = jnp.stack([omx, omy], axis=-1)
    cov_out = jnp.stack(
        [jnp.stack([o00, o01], axis=-1), jnp.stack([o01, o11], axis=-1)],
        axis=-2)
    return ow, mean_out, cov_out


def greedy_merge_channels(w, mx, my, c00, c01, c11, min_separation,
                          max_out: int, metric: int = 0,
                          use_kernel: bool = False,
                          interpret: bool = False):
    """Batched greedy merge in structure-of-arrays (channel-separated)
    layout.

    Semantically identical to vmapping ``greedy_merge`` over particles, but
    every array in the while-loop carries the big axes (P, K) last/innermost
    and scalar channels (mx, my, c00, c01, c11) separately, so no array
    carries tiny [2, 2] minor dimensions.

    use_kernel runs the on-chip merge (kernels/merge_pallas.py) instead;
    callers take it and ``interpret`` from kernels.kernel_mode.

    Returns channel outputs (w, mx, my, c00, c01, c11), each [P, max_out].

    Latency note: the loop body performs B=16 greedy picks per `while_loop`
    iteration. This is *exactly* the sequential greedy algorithm — pick b's
    cluster is the neighbors of the max-weight component outside clusters
    1..b-1, which is precisely what b sequential rounds would select — but
    with B x fewer loop iterations, which matters because each iteration
    carries fixed launch latency that dominates at small particle counts.
    """
    P, K = w.shape
    if use_kernel and metric in (0, 1):
        from phdslam_tpu.kernels.merge_pallas import greedy_merge_pallas
        return greedy_merge_pallas(w, mx, my, c00, c01, c11,
                                   float(min_separation), max_out,
                                   metric=metric, interpret=interpret)
    dtype = w.dtype
    col = jnp.arange(K)
    B = 16

    def one_pick(w_rem, out_block):
        pick = jnp.argmax(w_rem, axis=1)                      # [P]
        take = lambda a: jnp.take_along_axis(a, pick[:, None], axis=1)
        rmx, rmy = take(mx), take(my)
        r00, r01, r11 = take(c00), take(c01), take(c11)
        a00 = 0.5 * (r00 + c00)
        a01 = 0.5 * (r01 + c01)
        a11 = 0.5 * (r11 + c11)
        dx = rmx - mx
        dy = rmy - my
        if metric == 1:
            # Hellinger (device_math.cuh:388-413)
            s00, s01, s11 = r00 + c00, r01 + c01, r11 + c11
            det_sum = s00 * s11 - s01 * s01
            safe = jnp.maximum(det_sum, 1.17549435e-38)
            eps_q = -0.25 * (dx * dx * s11 - 2 * dx * dy * s01
                             + dy * dy * s00) / safe
            det_prod = ((r00 * c00 + r01 * c01) * (r01 * c01 + r11 * c11)
                        - (r00 * c01 + r01 * c11) * (r01 * c00 + r11 * c01))
            dist = 1.0 - jnp.sqrt(
                jnp.maximum(jnp.sqrt(jnp.maximum(det_prod, 0.0))
                            / (det_sum / 4.0), 0.0)) * jnp.exp(eps_q)
        else:
            det = a00 * a11 - a01 * a01
            dist = (dx * dx * a11 - 2 * dx * dy * a01 + dy * dy * a00) / det
        sel = (dist < min_separation) & (w_rem > 0)
        sel = sel | (col[None, :] == pick[:, None])
        active = jnp.any(w_rem > 0, axis=1)                   # [P]
        sel = sel & active[:, None]
        sw = jnp.where(sel, w_rem, 0.0)
        wsum = jnp.sum(sw, axis=1)                            # [P]
        inv = jnp.where(wsum > 0, 1.0 / jnp.maximum(wsum, 1e-38), 0.0)
        mux = jnp.sum(sw * mx, axis=1) * inv
        muy = jnp.sum(sw * my, axis=1) * inv
        ddx = mux[:, None] - mx
        ddy = muy[:, None] - my
        n00 = jnp.sum(sw * (c00 + ddx * ddx), axis=1) * inv
        n01 = jnp.sum(sw * (c01 + ddx * ddy), axis=1) * inv
        n11 = jnp.sum(sw * (c11 + ddy * ddy), axis=1) * inv
        # exhausted rows keep the identity-cov empty convention
        n00 = jnp.where(wsum > 0, n00, 1.0)
        n11 = jnp.where(wsum > 0, n11, 1.0)
        out_block.append((wsum, mux, muy, n00, n01, n11))
        return jnp.where(sel, 0.0, w_rem)

    def body(carry):
        i, w_rem, ow, omx, omy, o00, o01, o11 = carry
        block = []
        for _ in range(B):
            w_rem = one_pick(w_rem, block)
        outs = [jnp.stack([blk[f] for blk in block], axis=1)  # [P, B]
                for f in range(6)]
        upd = lambda dst, srcb: jax.lax.dynamic_update_slice_in_dim(
            dst, srcb, i, axis=1)
        return (i + B, w_rem, upd(ow, outs[0]), upd(omx, outs[1]),
                upd(omy, outs[2]), upd(o00, outs[3]), upd(o01, outs[4]),
                upd(o11, outs[5]))

    def cond(carry):
        i, w_rem, *_ = carry
        return (i < max_out) & jnp.any(w_rem > 0)

    # pad output capacity to a multiple of B for the block writes
    cap = ((max_out + B - 1) // B) * B
    zeros = jnp.zeros((P, cap), dtype)
    init = (jnp.array(0, jnp.int32), w, zeros, zeros, zeros,
            jnp.ones((P, cap), dtype), zeros,
            jnp.ones((P, cap), dtype))
    _, _, ow, omx, omy, o00, o01, o11 = jax.lax.while_loop(cond, body, init)
    trim = lambda a: a[:, :max_out]
    return (trim(ow), trim(omx), trim(omy), trim(o00), trim(o01),
            trim(o11))


def reduce_mixture_np(w, mean, cov, min_separation):
    """NumPy greedy reduction with the *CPU* reference's semantics
    (src/gm_reduce.cpp:57-134): sort by weight once, pop the front, merge all
    components within Mahalanobis distance (L-solve form), repeat. Used for
    the EAP expected-map estimate on host (src/main.cpp:290-316).

    Returns (w_out, mean_out, cov_out) as numpy arrays (dynamic length —
    host-side only, not jit-safe).
    """
    import numpy as np

    w = np.asarray(w, np.float64)
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    alive = w > 0
    order = np.argsort(-w, kind="stable")
    order = [i for i in order if alive[i]]
    used = np.zeros(len(w), bool)
    out_w, out_m, out_c = [], [], []
    for _ in range(len(order)):
        # first unused in weight order
        head = next((i for i in order if not used[i]), None)
        if head is None:
            break
        sigma_h = cov[head]
        members = [head]
        used[head] = True
        for j in order:
            if used[j]:
                continue
            sigma = 0.5 * (sigma_h + cov[j])
            diff = mean[head] - mean[j]
            try:
                L = np.linalg.cholesky(sigma)
                x = np.linalg.solve(L, diff)
                dist = float(np.dot(x, x))
            except np.linalg.LinAlgError:
                dist = np.inf
            if dist < min_separation:
                members.append(j)
                used[j] = True
        mw = w[members]
        wsum = mw.sum()
        mu = (mw[:, None] * mean[members]).sum(0) / wsum
        diffs = mu[None] - mean[members]
        sig = (mw[:, None, None]
               * (cov[members] + diffs[:, :, None] * diffs[:, None, :])
               ).sum(0) / wsum
        out_w.append(wsum)
        out_m.append(mu)
        out_c.append(sig)
    if not out_w:
        d = mean.shape[-1]
        return (np.zeros((0,)), np.zeros((0, d)), np.zeros((0, d, d)))
    return np.array(out_w), np.array(out_m), np.array(out_c)


def eval_mixture(w, mean, cov, x):
    """Evaluate the mixture intensity at points x [..., d]."""
    from phdslam_tpu.ops.linalg import gaussian_logpdf

    logpdf = gaussian_logpdf(x[..., None, :], mean, cov)  # [..., F]
    return jnp.sum(w * jnp.exp(logpdf), axis=-1)


def greedy_merge_channels3(w, m0, m1, m2, c00, c01, c02, c11, c12, c22,
                           min_separation, max_out: int):
    """3-D channelized greedy merge (the disparity-space analog of
    ``greedy_merge_channels``; reference merges 3-D disparity Gaussians with
    the same phdUpdateMergeKernel via the Gaussian3D overloads,
    src/phdfilter.cu:4977-4983 + device_math.cuh:331-345).

    Mahalanobis with averaged covariances, closed-form 3x3 adjugate/det.
    Returns channel outputs, each [P, max_out].
    """
    P, K = w.shape
    dtype = w.dtype
    col = jnp.arange(K)
    means = (m0, m1, m2)
    covs = (c00, c01, c02, c11, c12, c22)

    def body(carry):
        (i, w_rem, ow, o_m, o_c) = carry
        pick = jnp.argmax(w_rem, axis=1)
        take = lambda a: jnp.take_along_axis(a, pick[:, None], axis=1)
        rm = [take(m) for m in means]
        rc = [take(c) for c in covs]
        a00 = 0.5 * (rc[0] + c00)
        a01 = 0.5 * (rc[1] + c01)
        a02 = 0.5 * (rc[2] + c02)
        a11 = 0.5 * (rc[3] + c11)
        a12 = 0.5 * (rc[4] + c12)
        a22 = 0.5 * (rc[5] + c22)
        det = (a00 * (a11 * a22 - a12 * a12)
               - a01 * (a01 * a22 - a12 * a02)
               + a02 * (a01 * a12 - a11 * a02))
        i00 = a11 * a22 - a12 * a12
        i01 = a02 * a12 - a01 * a22
        i02 = a01 * a12 - a02 * a11
        i11 = a00 * a22 - a02 * a02
        i12 = a02 * a01 - a00 * a12
        i22 = a00 * a11 - a01 * a01
        d0 = rm[0] - m0
        d1 = rm[1] - m1
        d2 = rm[2] - m2
        dist = (d0 * d0 * i00 + d1 * d1 * i11 + d2 * d2 * i22
                + 2.0 * (d0 * d1 * i01 + d0 * d2 * i02 + d1 * d2 * i12)
                ) / det
        sel = (dist < min_separation) & (w_rem > 0)
        sel = sel | (col[None, :] == pick[:, None])
        active = jnp.any(w_rem > 0, axis=1)
        sel = sel & active[:, None]
        sw = jnp.where(sel, w_rem, 0.0)
        wsum = jnp.sum(sw, axis=1)
        inv = jnp.where(wsum > 0, 1.0 / jnp.maximum(wsum, 1e-38), 0.0)
        mu = [jnp.sum(sw * m, axis=1) * inv for m in means]
        dd = [mu[k][:, None] - means[k] for k in range(3)]
        n_c = [
            jnp.sum(sw * (c00 + dd[0] * dd[0]), axis=1) * inv,
            jnp.sum(sw * (c01 + dd[0] * dd[1]), axis=1) * inv,
            jnp.sum(sw * (c02 + dd[0] * dd[2]), axis=1) * inv,
            jnp.sum(sw * (c11 + dd[1] * dd[1]), axis=1) * inv,
            jnp.sum(sw * (c12 + dd[1] * dd[2]), axis=1) * inv,
            jnp.sum(sw * (c22 + dd[2] * dd[2]), axis=1) * inv,
        ]
        # exhausted rows keep the identity-cov empty convention
        for _di in (0, 3, 5):
            n_c[_di] = jnp.where(wsum > 0, n_c[_di], 1.0)
        ow = jax.lax.dynamic_update_index_in_dim(ow, wsum, i, 1)
        o_m = tuple(
            jax.lax.dynamic_update_index_in_dim(o_m[k], mu[k], i, 1)
            for k in range(3))
        o_c = tuple(
            jax.lax.dynamic_update_index_in_dim(o_c[k], n_c[k], i, 1)
            for k in range(6))
        w_rem = jnp.where(sel, 0.0, w_rem)
        return i + 1, w_rem, ow, o_m, o_c

    def cond(carry):
        i, w_rem, *_ = carry
        return (i < max_out) & jnp.any(w_rem > 0)

    zeros = jnp.zeros((P, max_out), dtype)
    ones = jnp.ones((P, max_out), dtype)
    init = (jnp.array(0, jnp.int32), w, zeros,
            (zeros, zeros, zeros),
            (ones, zeros, zeros, ones, zeros, ones))
    _, _, ow, o_m, o_c = jax.lax.while_loop(cond, body, init)
    return (ow,) + o_m + o_c
