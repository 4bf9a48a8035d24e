"""CPHD (Cardinalized PHD) filter pipeline.

Rebuild of the reference's dormant CPHD implementation (live code in
src/phdfilter.cu.bak; the same kernels sit commented-out in
src/phdfilter.cu:700-1822). Per Vo's analytic CPHD:

  constants    initCphdConstants / cphdConstantsKernel (.bak:370-449):
               log factorials, log binomial table, Poisson clutter
               cardinality
  predict      default: per-step Poisson prior of the in-range submap
               mass (the reference's live flow also rebuilds a Poisson
               prior each step, .bak:2473-2497, discarding its own
               cardinalityPredictKernel output); the kernel's log-domain
               convolution of prior with birth cardinality (.bak:512-545)
               is kept behind cfg.cnPoissonPredict=False
  births       birthsKernel (.bak:737-856): birth Gaussians added to the map
               *before* the update (optionally gated to measurements not
               explained by existing features, config keys gate_births /
               gate_threshold, src/main.cpp:997-999) + binomial birth
               cardinality B(k; n_births, birthWeight)
  pre-update   cphdPreUpdateKernel (.bak:1058-1184): same Kalman terms as
               the PHD path plus qdw_f = log(1-pd_f) + log w_f
  ESF          computeEsfKernel (.bak:1194-1286): elementary symmetric
               functions of Lambda_m = kappa^-1 * lambda_c * sum_f exp(lw),
               full and with each measurement deleted. NOTE: the reference's
               deleted-ESF recursion subtracts terms while rebuilding from
               scratch (.bak:1263-1272), which is neither the build-up (+)
               nor the deflation recursion — we compute the mathematically
               correct per-deleted-measurement build-up instead.
  Psi          computePsiKernel (.bak:1286-1430): Psi0/Psi1/Psi1d inner
               products with the predicted cardinality; posterior
               cardinality cn_update = cn_predict + psi0 - <Psi0,cn>
  update       cphdUpdateKernel (.bak:1436-1478): detection weights scaled
               by exp(<Psi1d_z,cn> - <Psi0,cn>) * lambda_c/kappa, nondetect
               weights by exp(<Psi1,cn> - <Psi0,cn>) * (1-pd); particle
               weight increment = <Psi0,cn> (.bak:2663-2668)

All fixed-shape: padded measurements contribute Lambda = 0 (exp(LOG0)),
which the ESF recursion ignores naturally.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filter.state import Gaussian2DMixture
from phdslam_tpu.filter.update import (
    detection_log_weights,
    kalman_preupdate,
)
from phdslam_tpu.ops.gm import greedy_merge_channels
from phdslam_tpu.ops.linalg import safe_log

NEG_INF = -jnp.inf


class CphdConstants(NamedTuple):
    log_factorial: jax.Array   # [N+1]
    log_binomial: jax.Array    # [N+1, N+1], [n, k] = log C(n, k)
    log_cn_clutter: jax.Array  # [N+1] Poisson(clutterRate) log-pmf


def make_constants(cfg: SlamConfig) -> CphdConstants:
    n = cfg.maxCardinality + 1
    lf = jnp.cumsum(jnp.log(jnp.maximum(jnp.arange(n), 1.0)))
    ns = jnp.arange(n)[:, None]
    ks = jnp.arange(n)[None, :]
    lbin = jnp.where(ks <= ns, lf[ns] - lf[ks] - lf[jnp.maximum(ns - ks, 0)],
                     NEG_INF)
    lam = cfg.clutterRate
    cn_clutter = jnp.arange(n) * safe_log(jnp.asarray(lam)) - lam - lf
    return CphdConstants(log_factorial=lf, log_binomial=lbin,
                         log_cn_clutter=cn_clutter)


def cardinality_predict(cn_prior, cn_birth):
    """Log-domain convolution (cardinalityPredictKernel,
    src/phdfilter.cu:867-888): cn_pred[n] = lse_j<=n (birth[n-j] + prior[j]).

    cn_prior [..., N+1] log-pmf; cn_birth broadcastable [..., N+1].
    """
    n = cn_prior.shape[-1]
    ns = jnp.arange(n)[:, None]
    js = jnp.arange(n)[None, :]
    mask = js <= ns
    idx = jnp.clip(ns - js, 0, n - 1)                  # [n, j]
    b = jnp.take(cn_birth, idx, axis=-1)               # [..., n, j]
    full = jnp.where(mask, b + cn_prior[..., None, :], NEG_INF)
    return jax.scipy.special.logsumexp(full, axis=-1)


def birth_cardinality(n_births, birth_weight, consts: CphdConstants):
    """Binomial birth cardinality B(k; n, p) in log domain
    (birthsKernel, src/phdfilter.cu.bak:776-791). n_births may be traced
    (per-particle when births are gated)."""
    nmax = consts.log_factorial.shape[0]
    k = jnp.arange(nmax)
    n = n_births
    lf = consts.log_factorial
    n_i = jnp.asarray(n, jnp.int32)
    lbin = (lf[n_i] - lf[jnp.minimum(k, n_i)]
            - lf[jnp.maximum(n_i - k, 0)])
    p = jnp.asarray(birth_weight, jnp.float32)
    out = lbin + k * safe_log(p) + (n_i - k) * safe_log(1.0 - p)
    return jnp.where(k <= n_i, out, NEG_INF)


def esf_log(log_lambda):
    """Elementary symmetric functions of {exp(log_lambda_m)} in log domain.

    Returns [M+1] log-esf coefficients (esf[0] = 0 == log 1). The standard
    Vieta build-up e_k <- e_k + Lambda_j * e_{k-1} as a `lax.scan` over
    measurements (the reference's in-shared-memory recursion,
    .bak:1233-1247). Entries with log_lambda = -inf contribute nothing, so
    padded measurement slots are handled for free.
    """
    m = log_lambda.shape[-1]
    init = jnp.full(log_lambda.shape[:-1] + (m + 1,), NEG_INF)
    init = init.at[..., 0].set(0.0)

    def step(e, ll):
        shifted = jnp.concatenate(
            [jnp.full(e.shape[:-1] + (1,), NEG_INF), e[..., :-1]], axis=-1)
        e_new = jnp.logaddexp(e, ll[..., None] + shifted)
        return e_new, None

    lam_t = jnp.moveaxis(log_lambda, -1, 0)
    out, _ = jax.lax.scan(step, init, lam_t)
    return out


def esf_deleted(log_lambda):
    """log-ESF with each measurement deleted: [..., M, M] where entry
    [m, k] = e_k of the set excluding m (orders 0..M-1).

    The reference kernel (.bak:1255-1277) rebuilds with a subtraction in the
    recursion, which is not a valid ESF recursion; here each deleted set is
    rebuilt with the correct (+) recursion (O(M^3) total — trivial work at
    M <= 256, fully parallel over the deleted index)."""
    m = log_lambda.shape[-1]

    def one(mi):
        ll = jnp.where(jnp.arange(m) == mi, NEG_INF, log_lambda)
        return esf_log(ll)[..., :m]

    return jax.vmap(one, out_axes=-2)(jnp.arange(m))


def _conv_log(a, b):
    """Log-domain polynomial product: out_k = lse_i(a_i + b_{k-i}).

    a [..., La], b [..., Lb] -> [..., La+Lb-1]. Fully parallel (no scan)."""
    la, lb = a.shape[-1], b.shape[-1]
    kk = jnp.arange(la + lb - 1)[:, None]               # [K, 1]
    ii = jnp.arange(la)[None, :]                        # [1, La]
    jj = kk - ii                                        # [K, La]
    valid = (jj >= 0) & (jj < lb)
    bj = jnp.take(b, jnp.clip(jj, 0, lb - 1), axis=-1)  # [..., K, La]
    terms = jnp.where(valid, a[..., None, :] + bj, NEG_INF)
    return jax.scipy.special.logsumexp(terms, axis=-1)  # [..., K]


def esf_all(log_lambda):
    """Full and per-measurement-deleted log-ESFs by divide and conquer.

    Returns (esf [..., M+1], esfd [..., M, M]) == (esf_log(ll),
    esf_deleted(ll)) but with O(log M) sequential depth instead of the
    O(M)-step scan (and O(M) scans for the deleted sets). Up-sweep:
    pairwise log-polynomial products up a binary tree; down-sweep: each
    node's complement polynomial = parent complement x sibling, so every
    leaf ends with the ESF of all OTHER measurements (the prefix-suffix
    product trick). M is padded to a power of two with -inf entries (unit
    polynomials), which drop out exactly.

    psi_terms uses the scan forms esf_log + esf_deleted: the down-sweep's
    take-based log-convolutions materialize large intermediates. This
    stays as a tested alternative for shapes where the scan's sequential
    depth dominates (very large M, small P); its speed on the GPU is not
    measured.
    """
    m = log_lambda.shape[-1]
    mp = 1
    while mp < m:
        mp *= 2
    batch = log_lambda.shape[:-1]
    ll = jnp.concatenate(
        [log_lambda,
         jnp.full(batch + (mp - m,), NEG_INF, log_lambda.dtype)], axis=-1) \
        if mp != m else log_lambda

    # up-sweep: levels[k] holds [..., mp/2^k, 2^k + 1] node polynomials
    zeros = jnp.zeros(batch + (mp, 1), ll.dtype)
    levels = [jnp.concatenate([zeros, ll[..., None]], axis=-1)]
    cur = levels[0]
    while cur.shape[-2] > 1:
        cur = _conv_log(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    esf_full = cur[..., 0, :]                           # [..., mp+1]

    # down-sweep: comp[node] = esf of everything outside the node's subtree
    comp = jnp.zeros(batch + (1, 1), ll.dtype)          # root: unit poly
    for lv in range(len(levels) - 2, -1, -1):
        nodes = levels[lv]                              # [..., n, L]
        left, right = nodes[..., 0::2, :], nodes[..., 1::2, :]
        comp_left = _conv_log(comp, right)
        comp_right = _conv_log(comp, left)
        comp = jnp.stack([comp_left, comp_right], axis=-2) \
            .reshape(batch + (nodes.shape[-2], comp_left.shape[-1]))
    # comp is [..., mp, mp]: leaf m's complement = esf without m
    return esf_full[..., : m + 1], comp[..., :m, :m]


class CphdUpdateTerms(NamedTuple):
    cn_update: jax.Array          # [P, N+1] posterior cardinality (log)
    log_lik: jax.Array            # [P] <Psi0, cn> particle weight increment
    scale_detect: jax.Array       # [P, M] log-scale for detection weights
    scale_nondetect: jax.Array    # [P] log-scale for non-detection weights


def psi_terms(sum_l, qdw, w, valid_mask, z_valid, cn_predict,
              consts: CphdConstants, cfg: SlamConfig) -> CphdUpdateTerms:
    """Compute Vo's Psi inner products (computePsiKernel, .bak:1286-1430).

    sum_l [P,M]: log of the per-measurement detection mass
    logsumexp_f(log pd + log w + log N(z; S)) over in-range features —
    the only statistic of the [P,M,F] cross-product the Psi machinery
    needs (so the fused select kernel's sum_exp feeds it directly);
    qdw [P,F] log((1-pd_f) w) with the PER-FEATURE pd (0 outside the
    FOV); w [P,F] linear; cn_predict [P,N+1] log.

    valid_mask [P,F] marks the features the CPHD machinery operates on.
    The reference launches every CPHD kernel on the in-range SUBMAP
    (dev_maps_inrange: rclass != 0, i.e. in-range + nearly-in-range
    features; .bak:2199-2273), so <q_D,w> and <1,w> are submap sums —
    pass set_mask = (w > 0) & (rclass != 0). Within the set, qdw carries
    the per-feature pd (cphdPreUpdateKernel .bak:1183 writes
    qdw = log(1-featurePd)+log(w) with featurePd = 0 for nearly-in-range
    features). The resulting posterior cn is the submap-evidence-
    reweighted prior: with the Poisson full-map prior the reference
    rebuilds each step (.bak:2473-2497) it concentrates near the
    CURRENTLY-DETECTABLE feature count, not the total map size — the
    total-map cardinality estimate is the intensity mass, which the
    caller preserves exactly via the out-of-range passthrough.
    """
    P, M = sum_l.shape
    ncard = cn_predict.shape[-1]
    lf = consts.log_factorial
    lbin = consts.log_binomial
    cn_clut = consts.log_cn_clutter

    # Lambda_m = kappa^-1 lambda_c <pd w, N(z)> (log; .bak:1206-1221)
    log_lambda = (sum_l + safe_log(jnp.asarray(cfg.clutterRate))
                  - safe_log(jnp.asarray(cfg.clutterDensity)))
    log_lambda = jnp.where(z_valid[None, :], log_lambda, NEG_INF)

    # Scan build-up for the full ESF, vmapped rebuilds for the deleted
    # ones. The O(log M)-depth divide-and-conquer alternative (esf_all)
    # was measured SLOWER on the chip (11.7 vs 6.9 ms at P=1024, M=64):
    # its down-sweep convolutions materialize [P, M, M, M/2]-scale
    # logsumexp tensors, which cost more than the scan's M tiny dependent
    # steps. Kept as an option + oracle-pinned test.
    esf = esf_log(log_lambda)                                   # [P, M+1]
    esfd = esf_deleted(log_lambda)                              # [P, M, M]

    # Inner products <q_D, w> and <1, w> (log). The reference's form
    # multiplies (n-j)*log<qd,w> and subtracts n*log<1,w> — with LOG0
    # sentinels this relies on exact cancellation of +-huge products, which
    # float32 reassociation destroys (the huge addend annihilates the finite
    # part of the term). We refactor algebraically:
    #   (n-a) ip_qdw - n log_wsum
    #     = (n-a) log_ratio - j log_wsum - u log_wsum,   a = j + u,
    # with log_ratio = log(<qd,w>/<1,w>) in [-30, 0] (an average of
    # log(1-pd), bounded) and the -j log_wsum folded into the ESF
    # coefficients. All magnitudes stay ~O(30*n): no cancellation hazards,
    # exact whenever the map is non-empty.
    ip_qdw = jax.scipy.special.logsumexp(
        jnp.where(valid_mask, qdw, NEG_INF), axis=-1)           # [P]
    ip_qdw = jnp.maximum(ip_qdw, -1e30)
    log_wsum_raw = jnp.maximum(
        safe_log(jnp.sum(jnp.where(valid_mask, w, 0.0), axis=-1)), -1e30)
    log_ratio = jnp.clip(ip_qdw - log_wsum_raw, -30.0, 0.0)     # [P]
    log_wsum = jnp.maximum(log_wsum_raw, -30.0)

    m_count = jnp.sum(z_valid.astype(jnp.int32))
    n_idx = jnp.arange(ncard)                                   # [N+1]
    j_idx = jnp.arange(M + 1)                                   # [J]

    mj = jnp.clip(m_count - j_idx, 0, ncard - 1)                # [J]
    j_ok = j_idx <= m_count

    def psi(esf_j, shift, j_valid):
        """psi[n] = lse_j ( perm(n, j+shift) + lfact[m'-j] + cnc[m'-j]
                            + (esf_j[j] - j log_wsum)
                            + (n-(j+shift)) log_ratio - shift log_wsum )
        esf_j [P, J]; returns [P, N+1]."""
        a = j_idx + shift                                       # [J]
        a_c = jnp.clip(a, 0, ncard - 1)
        # perm(n, a) = log C(n,a) + lfact[a] = log(n!/(n-a)!); only a <= n
        perm = lbin[n_idx[:, None], a_c[None, :]] + lf[a_c][None, :]
        valid = j_valid[None, :] & (a[None, :] <= n_idx[:, None])  # [N+1,J]
        esf_norm = esf_j - j_idx[None, :] * log_wsum[:, None]   # [P,J]
        aux = (lf[mj] + cn_clut[mj])[None, None, :] + esf_norm[:, None, :]
        pow_term = ((n_idx[None, :, None] - a[None, None, :])
                    * log_ratio[:, None, None])
        terms = (aux + jnp.where(valid, perm, 0.0)[None] + pow_term
                 - shift * log_wsum[:, None, None])
        terms = jnp.where(valid[None], terms, NEG_INF)
        return jax.scipy.special.logsumexp(terms, axis=-1)      # [P, N+1]

    psi0 = psi(esf, 0, j_ok)                                    # [P, N+1]
    psi1 = psi(esf, 1, j_ok)

    ip0 = jax.scipy.special.logsumexp(psi0 + cn_predict, axis=-1)   # [P]
    ip1 = jax.scipy.special.logsumexp(psi1 + cn_predict, axis=-1)

    # Psi1 deleted terms: esf -> esfd[m], clutter/factorial args use m-1-j.
    # Only ip1d = <Psi1d_m, cn> is needed (the [P,M] detection scales), and
    # the (n, j) factor is independent of WHICH measurement is deleted —
    # reduce over n first:
    #   C[p,j] = lse_n( cn[p,n] + perm(n, j+1) + (n-j-1) log_ratio[p] )
    #   ip1d[p,m] = lse_j( esfd_norm[p,m,j] + lf[m'-1-j] + cnc[m'-1-j]
    #                      + C[p,j] - log_wsum[p] )
    # This is an exact reassociation of lse_n(cn + lse_j(...)) that shrinks
    # the working set from [P,M,N+1,M] (1 GB at the CPHD baseline config)
    # to [P,N+1,M] + [P,M,M].
    mj1 = jnp.clip(m_count - 1 - j_idx[:M], 0, ncard - 1)       # [M]
    j1_ok = j_idx[:M] <= jnp.maximum(m_count - 1, 0)
    a1 = j_idx[:M] + 1
    a1_c = jnp.clip(a1, 0, ncard - 1)
    perm1 = lbin[n_idx[:, None], a1_c[None, :]] + lf[a1_c][None, :]
    valid_nj = a1[None, :] <= n_idx[:, None]                    # [N+1,M]
    pow1 = ((n_idx[None, :, None] - a1[None, None, :])
            * log_ratio[:, None, None])                        # [P,N+1,M]
    cterm = (cn_predict[:, :, None]
             + jnp.where(valid_nj, perm1, 0.0)[None] + pow1)
    cterm = jnp.where(valid_nj[None], cterm, NEG_INF)
    c_pj = jax.scipy.special.logsumexp(cterm, axis=1)           # [P,M]
    esfd_norm = esfd - j_idx[None, None, :M] * log_wsum[:, None, None]
    d_term = (esfd_norm + (lf[mj1] + cn_clut[mj1])[None, None, :]
              + c_pj[:, None, :] - log_wsum[:, None, None])     # [P,M,Mj]
    d_term = jnp.where(j1_ok[None, None, :], d_term, NEG_INF)
    ip1d = jax.scipy.special.logsumexp(d_term, axis=-1)         # [P,M]

    cn_update = cn_predict + psi0 - ip0[:, None]

    # weight scales (cphdUpdateKernel, .bak:1446-1478). scale_nondetect
    # is the GLOBAL <Psi1,cn>/<Psi0,cn> ratio only; the caller applies
    # the per-feature (1-pd_f) via qdw (Vo's v_upd = <Y1,cn>/<Y0,cn> *
    # (1-pd(x)) * v_pred; the reference folds in the config pd for every
    # feature, .bak:1469-1471, which is wrong for out-of-FOV features).
    scale_detect = (ip1d - ip0[:, None]
                    + safe_log(jnp.asarray(cfg.clutterRate))
                    - safe_log(jnp.asarray(cfg.clutterDensity)))  # [P,M]
    scale_nondetect = ip1 - ip0                                   # [P]

    return CphdUpdateTerms(cn_update=cn_update, log_lik=ip0,
                           scale_detect=scale_detect,
                           scale_nondetect=scale_nondetect)


def add_births(state_map: Gaussian2DMixture, pose, z_rb, z_valid,
               cfg: SlamConfig, consts: CphdConstants):
    """Insert birth Gaussians into the map before the update (addBirths /
    birthsKernel, .bak:737-856). With gate_births, only measurements not
    explained by an existing feature give birth (Mahalanobis gate on the
    predicted measurement, config gate_threshold).

    Returns (map_with_births, cn_birth [P, N+1]).
    """
    P, F = state_map.w.shape
    M = z_rb.shape[0]

    # gating: measurement m compatible with an existing feature?
    if cfg.gateBirths:
        from phdslam_tpu.models.measurement import predict_measurement
        from phdslam_tpu.ops.linalg import wrap_angle
        mean_xy = jnp.stack([state_map.mx, state_map.my], axis=-1)
        r, b, dx, dy, r2 = predict_measurement(pose[:, None, :], mean_xy)
        ir = z_rb[None, :, None, 0] - r[:, None, :]
        ib = wrap_angle(z_rb[None, :, None, 1] - b[:, None, :])
        # rough gate with measurement noise scale (the reference gates on
        # the pre-update innovation covariance; birth gating happens before
        # the pre-update so the measurement-noise gate is the usable proxy)
        d2 = (ir / cfg.stdRange) ** 2 + (ib / cfg.stdBearing) ** 2
        compatible = jnp.any(
            (d2 < cfg.gateThreshold ** 2) & state_map.valid[:, None, :],
            axis=-1)                                            # [P,M]
        birth_ok = z_valid[None, :] & ~compatible
    else:
        birth_ok = jnp.broadcast_to(z_valid[None, :], (P, M))

    theta = pose[:, None, 2] + z_rb[None, :, 1]
    ct, st = jnp.cos(theta), jnp.sin(theta)
    bdx = z_rb[None, :, 0] * ct
    bdy = z_rb[None, :, 0] * st
    var_r = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_b = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    bw = jnp.where(birth_ok, cfg.birthWeight, 0.0)

    # union map + births, keep top-F by weight
    cat = lambda a, b: jnp.concatenate([a, b], axis=-1)
    uw = cat(state_map.w, bw)
    top_w, idx = jax.lax.top_k(uw, F)
    take = lambda a, b: jnp.take_along_axis(cat(a, b), idx, axis=1)
    new_map = Gaussian2DMixture(
        w=top_w,
        mx=take(state_map.mx, pose[:, None, 0] + bdx),
        my=take(state_map.my, pose[:, None, 1] + bdy),
        c00=take(state_map.c00, ct * ct * var_r + bdy * bdy * var_b),
        c01=take(state_map.c01, ct * st * var_r - bdy * bdx * var_b),
        c11=take(state_map.c11, st * st * var_r + bdx * bdx * var_b))

    n_births = jnp.sum(birth_ok.astype(jnp.int32), axis=-1)     # [P]
    cn_birth = jax.vmap(
        lambda n: birth_cardinality(n, cfg.birthWeight, consts))(n_births)
    return new_map, cn_birth


def cphd_update(pose, gm: Gaussian2DMixture, cn_predict, z_rb, z_label,
                z_valid, cfg: SlamConfig, consts: CphdConstants):
    """Full CPHD measurement update: Kalman pre-update (shared with the PHD
    path), ESF/Psi machinery, weight scaling, merge, cardinality posterior.

    cn_predict [P,N+1] is the carried (convolution-propagated) prior; it
    is only consumed when cfg.cnPoissonPredict is False. The default
    rebuilds the prior as Poisson(full-map mass), matching the
    reference's live host flow (.bak:2473-2497).

    Returns (map_out, cn_update, log_weight_delta).
    """
    P, F = gm.w.shape
    M = z_rb.shape[0]

    pre = kalman_preupdate(pose, gm, cfg)
    in_mask = pre.rclass == 1
    valid_mask = gm.w > 0                                       # [P,F]
    # The reference's CPHD update operates on the in-range SUBMAP only:
    # the host driver splits each map into rclass!=0 features (in-range +
    # nearly-in-range) and the out-of-range remainder, launches every
    # CPHD kernel on dev_maps_inrange alone, and recombines the updated
    # submap with the UNTOUCHED out-of-range features afterwards
    # (.bak:2199-2273 split, .bak:2546-2580 recombine). Out-of-FOV
    # features therefore keep their weights verbatim — scaling the whole
    # map by the global exp(ip1-ip0) < 1 ratio every step (what this
    # function did before) leaks all out-of-FOV mass within a few steps.
    set_mask = valid_mask & (pre.rclass != 0)                   # [P,F]
    qdw = jnp.where(set_mask,
                    safe_log(1.0 - pre.pd) + safe_log(gm.w), NEG_INF)
    minw = cfg.minFeatureWeight
    # fast mode keeps the top-4 detection candidates per measurement, as
    # in the static path (filter/update.py k1 rationale)
    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)

    if cfg.cnPoissonPredict:
        # Predicted-cardinality prior: Poisson pmf of the IN-RANGE
        # submap's post-birth intensity mass, rebuilt on every step.
        # The reference's live flow rebuilds a Poisson prior each step
        # too (.bak:2473-2497 — the cardinalityPredictKernel convolution
        # is computed but overwritten before use), and its dedicated
        # separateCardinalityKernel (.bak:986-1046, the exact
        # Poisson-binomial of the submap weights) shows the prior is
        # meant to describe the submap the Psi machinery operates on.
        # Using the FULL-map mass here while the ESF/Psi evidence covers
        # only the in-range submap makes exp(ip1d - ip0) blow up as the
        # map outgrows the FOV (measured: intensity mass 1777 on an
        # 80-landmark scenario by step 40); the submap-consistent prior
        # keeps every scale normalized.
        w_sum = jnp.sum(jnp.where(set_mask, gm.w, 0.0), axis=-1)    # [P]
        ncard = consts.log_factorial.shape[0]
        n_idx = jnp.arange(ncard)
        cn_predict = (n_idx[None, :] * safe_log(w_sum)[:, None]
                      - w_sum[:, None] - consts.log_factorial[None, :])
        cn_predict = cn_predict - jax.scipy.special.logsumexp(
            cn_predict, axis=-1, keepdims=True)

    from phdslam_tpu.kernels import kernel_mode
    use_pallas, interp = kernel_mode(cfg)
    if use_pallas:
        # fused kernel (raw mode): per-measurement detection masses +
        # unnormalized top-k1 detection candidates in one pass — the
        # [P,M,F] cross-product is never materialized (psi_terms only
        # needs its per-measurement logsumexp)
        nv = jnp.max(jnp.where(z_valid, jnp.arange(z_rb.shape[0]) + 1, 0))
        from phdslam_tpu.kernels.preupdate_pallas import fused_update_select
        (sum_exp, e_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
         _lpw_sel, _compat) = fused_update_select(
            z_rb, pre, gm, cfg, k1=k1, raw=True, n_valid=nv,
            with_compat=False, with_lpw=False, interpret=interp)
        if cfg.labeledMeasurements:
            m_ok = z_valid & (z_label == 0)
        else:
            m_ok = z_valid
        sum_exp = jnp.where(m_ok[None, :], sum_exp, 0.0)
        e_sel = jnp.where(m_ok[None, :, None], e_sel, 0.0)
        sum_l = jnp.where(sum_exp > 0, safe_log(sum_exp), NEG_INF)
    else:
        lw = detection_log_weights(pre, gm, z_rb, z_label, z_valid, cfg)
        sum_l = jax.scipy.special.logsumexp(
            jnp.where(in_mask[:, None, :], lw, NEG_INF), axis=-1)

    terms = psi_terms(sum_l, qdw, gm.w, set_mask, z_valid, cn_predict,
                      consts, cfg)

    # weights (cphdUpdateKernel): no per-measurement normalizer — the Psi
    # inner products play that role. The non-detection scale
    # (1-pd_f) * exp(ip1-ip0) applies to the in-range SET only; out-of-
    # range features pass through with their weights unchanged (the
    # reference recombines them verbatim, .bak:2546-2580). Within the
    # set, qdw carries the per-feature pd — nearly-in-range features
    # (pd=0) keep full mass times the global Psi ratio, which is the
    # reference's cphdUpdateKernel behavior modulo its use of the config
    # pd for every set feature (.bak:1469-1471, documented deviation).
    w_nondetect = jnp.where(
        set_mask, jnp.exp(qdw + terms.scale_nondetect[:, None]),
        jnp.where(valid_mask, gm.w, 0.0))

    # prune + pool + merge. Same sectioned, gather-free layout as the PHD
    # path (filter/update.py): [originals F | per-measurement top-k1
    # detections M*k1]; the merge output IS the new map (the reference
    # merges the recombined in+out map in one pass too, .bak:2580-2613).
    # CPHD births entered the map pre-update (add_births), so there is
    # no birth section.
    w_sec1 = jnp.where(w_nondetect >= minw, w_nondetect, 0.0)

    if use_pallas:
        # recombine in log space: exp(scale_detect) alone can overflow
        # float32 (the Psi inner-product ratios reach +-90) even when the
        # product with the detection value is moderate
        w_sel = jnp.exp(safe_log(e_sel)
                        + terms.scale_detect[:, :, None])
        w_sel = jnp.where(w_sel >= minw, w_sel, 0.0)
    else:
        from phdslam_tpu.filter.update import gather_selected
        w_detect = jnp.exp(lw + terms.scale_detect[:, :, None])  # [P,M,F]
        w_det_p = jnp.where(w_detect >= minw, w_detect, 0.0)
        w_sel, f_sel = jax.lax.top_k(w_det_p, k1)               # [P,M,k1]
        (mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
         _lpw_sel) = gather_selected(pre, gm, z_rb, f_sel,
                                     with_lpw=False)

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b: jnp.concatenate([a, b], axis=-1)
    cand_w = cat(w_sec1, flat(w_sel))
    if cfg.mergeMode == 1:
        from phdslam_tpu.ops.gm import fast_prune_renormalize
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    cand_mx = cat(gm.mx, flat(mx_sel))
    cand_my = cat(gm.my, flat(my_sel))
    cand_00 = cat(gm.c00, flat(u00_sel))
    cand_01 = cat(gm.c01, flat(u01_sel))
    cand_11 = cat(gm.c11, flat(u11_sel))

    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        cand_w, cand_mx, cand_my, cand_00, cand_01, cand_11,
        cfg.minSeparation, F, metric=cfg.distanceMetric,
        use_kernel=use_pallas, interpret=interp)
    map_out = Gaussian2DMixture(w=mw, mx=mmx, my=mmy, c00=m00, c01=m01,
                                c11=m11)

    return map_out, terms.cn_update, terms.log_lik
