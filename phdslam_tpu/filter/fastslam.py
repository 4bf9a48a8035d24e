"""FastSLAM with per-particle EKF landmark maps and joint data association.

The WORKING counterpart of the reference's vestigial FastSLAM subsystem
(src/fastslam.cu, 447 lines; src/munkres.cu, 378 lines): neither file is in
the build (.pro SOURCES) and neither compiles (undeclared `m` at
src/munkres.cu:22, malformed struct at src/munkres.cu:3-7, empty
jcbb_kernel at src/fastslam.cu:412, update() ends mid-function at
src/fastslam.cu:447). What the skeleton INTENDED is recoverable:

  - preupdate_kernel (src/fastslam.cu:369-408): per-(measurement, feature)
    EKF terms — Kalman gain, updated mean/cov, Mahalanobis distance matrix
    Q for data association.
  - munkres_assign (src/fastslam.cu:21-366): joint optimal assignment of
    measurements to features.
  - jcbb_kernel (src/fastslam.cu:412): joint-compatibility branch & bound
    (empty stub; see ops/jcbb.py).
  - update (src/fastslam.cu:417-447): per-particle EKF map update +
    particle importance weighting.

This module rebuilds that intent for a data-parallel device instead of
translating it:

  - the EKF pre-update is the SAME channelized [P, F] Kalman math the PHD
    update uses (filter/update.kalman_preupdate — one implementation, two
    filters), and the association log-likelihood matrix is a [P, M, F]
    tensor of elementwise work, exactly like the PHD detection terms.
  - joint assignment runs as a Jacobi (all-rows-bid-in-parallel) forward
    auction with eps-scaling — the same data-parallel formulation as
    ops/ospa._auction_assign, extended to the rectangular
    measurements x (features + no-match) problem. Every measurement owns a
    private "no match" column priced at the clutter/new-landmark
    log-likelihood, so the auction's objective IS the joint association
    log-likelihood and feasibility is unconditional. vmapped over
    particles: one auction iteration is a handful of [P, M, F+M] tensor
    ops, not P independent host solves.
  - landmark existence is a per-feature evidence counter in the mixture's
    weight channel (the classic FastSLAM landmark-quality counter:
    +1 when associated, -1 when inside the FOV but unassociated, delete at
    0) — so the shared Gaussian2DMixture / SlamState / logging /
    checkpoint machinery applies unchanged.

Association modes (cfg.fastslamAssoc):
  0 = per-measurement ML (gated argmax) with winner-takes-feature conflict
      resolution — the classic FastSLAM 1.0 association;
  1 = joint auction assignment (default) — the working realization of the
      reference's munkres_assign intent.

The particle weight increment is the exact joint association
log-likelihood (conditioned on the sampled pose):

    dw = sum_{f in FOV} log(1 - pd)
       + sum_{m matched}  [ log pd + log N(innov; 0, S_f) - log(1 - pd) ]
       + sum_{m unmatched} log clutterDensity

which the auction maximizes over assignments (per-measurement terms are
the auction benefits), so mode 1 weights each particle by its best joint
association hypothesis.

JCBB itself (the empty jcbb_kernel) lives in ops/jcbb.py: under FastSLAM's
per-particle conditioning the pose is KNOWN, measurements are independent,
and joint compatibility degenerates to individual gating + mutual
exclusion — i.e. exactly the auction above. JCBB's branch-and-bound only
adds power when pose uncertainty correlates the innovations (EKF-SLAM
style), which is what ops/jcbb.py implements (and tests demonstrate).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filter.state import Gaussian2DMixture
from phdslam_tpu.filter.update import LOG_2PI, kalman_preupdate
from phdslam_tpu.models.measurement import birth_gaussian
from phdslam_tpu.ops.linalg import wrap_angle

#: "impossible" benefit for gated-out / invalid pairs. Finite (not -inf) so
#: auction arithmetic (bid = best - second + eps) stays NaN-free.
_NEG = -1e30

# Benefits are log-likelihoods in nats; relative differences below
# _EPS_FINAL (of the live-benefit span) are immaterial to the association
# decision. NB: unlike ops/ospa._auction_assign, this rectangular auction
# runs a SINGLE phase from zero prices — eps-scaling restarts are unsound
# here: a phase restart resets ownership but keeps prices, and a column
# that stays unowned at an inflated price leaks the duality bound when
# there are more columns than rows (in the square OSPA problem every
# column ends owned, so the leak cannot occur). From zero prices a column
# is only ever priced by a bid that also takes ownership, so every priced
# column ends owned and the classic within-m*eps bound holds.
_EPS_FINAL = 1e-3
_BIDS_PER_ROW = 128


def _auction_rows(benefit):
    """Rectangular Jacobi forward auction, maximizing total benefit.

    benefit [M, C]: rows = bidders (all must be assigned), columns =
    objects. Returns col_of_row [M] int32. Callers guarantee every row has
    at least one column only IT can win (a private no-match column), which
    bounds the worst case: a row outbid everywhere else always terminates
    on its private column. Single phase from zero prices (see the
    _EPS_FINAL note above for why eps-scaling restarts are unsound in the
    rectangular case); terminates within m*eps*span of the optimal total
    benefit, and if the bid budget is ever exhausted, still-unassigned
    rows fall back to a column only they can win — feasible, possibly
    suboptimal.
    """
    m, c = benefit.shape
    rows = jnp.arange(m)
    cols = jnp.arange(c)

    # Clamp gated-out pairs to a finite floor a few spans below the live
    # values instead of carrying -1e30 through the price dynamics: a bid of
    # (v_best - v_second) against a -1e30 runner-up explodes the column
    # price past float32 resolution and corrupts every later comparison.
    # Any floor below (min_live - span) preserves the optimum — an
    # assignment using a clamped pair still loses to the row's live
    # private column — while keeping all arithmetic within ~5 spans.
    live = benefit > _NEG / 2
    hi = jnp.max(jnp.where(live, benefit, -jnp.inf))
    lo = jnp.min(jnp.where(live, benefit, jnp.inf))
    hi = jnp.where(jnp.isfinite(hi), hi, 0.0)   # degenerate: nothing live
    lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
    span = jnp.maximum(hi - lo, 1.0)
    floor = lo - 4.0 * span - 1.0
    benefit = jnp.where(live, benefit, floor)
    eps = _EPS_FINAL * span
    budget = _BIDS_PER_ROW * c

    def cond(s):
        it, _, _, assigned = s
        return (~jnp.all(assigned)) & (it < budget)

    def body(s):
        it, price, owner, assigned = s
        values = benefit - price[None, :]
        j_best = jnp.argmax(values, axis=1)
        v_best = jnp.take_along_axis(values, j_best[:, None], 1)[:, 0]
        v_second = jnp.max(
            values.at[rows, j_best].set(-jnp.inf), axis=1)
        v_second = jnp.where(jnp.isfinite(v_second), v_second, v_best)
        bid_inc = v_best - v_second + eps
        bid_mat = jnp.where(
            (~assigned)[:, None] & (j_best[:, None] == cols[None, :]),
            bid_inc[:, None], -jnp.inf)
        col_bid = jnp.max(bid_mat, axis=0)
        col_bidder = jnp.argmax(bid_mat, axis=0)
        win = jnp.isfinite(col_bid)
        price = jnp.where(win, price + col_bid, price)
        owner = jnp.where(win, col_bidder, owner)
        assigned = jnp.zeros_like(assigned).at[
            jnp.where(owner >= 0, owner, m)].set(True, mode="drop")
        return it + 1, price, owner, assigned

    init = (jnp.array(0, jnp.int32), jnp.zeros((c,), benefit.dtype),
            jnp.full((c,), -1, jnp.int32), jnp.zeros((m,), bool))
    _, _, owner, _ = jax.lax.while_loop(cond, body, init)

    # col_of_row: the lowest column owned by each row (a converged auction
    # gives each row exactly one)
    owned_col = jnp.where(owner[None, :] == rows[:, None],
                          cols[None, :], c)
    col = jnp.min(owned_col, axis=1)
    # fallback for any row left unassigned after the budget: its best
    # column among those only it can win (live for it, gated for every
    # other row) — with the private no-match columns of fastslam_update
    # this is exactly column F + m
    others = jnp.sum(live, axis=0, keepdims=True) - live.astype(jnp.int32)
    private = jnp.where(live & (others == 0), benefit, -jnp.inf)
    col = jnp.where(col < c, col, jnp.argmax(private, axis=1))
    return col.astype(jnp.int32)


def fastslam_update(pose, gm: Gaussian2DMixture, z_rb, z_valid,
                    cfg: SlamConfig):
    """One FastSLAM measurement update over all particles.

    pose [P, 6]; gm: per-particle EKF landmark maps (w = existence
    counter); z_rb [M, 2] padded measurements with z_valid [M].
    Returns (gm_out, dw [P]) with dw the per-particle joint association
    log-likelihood increment (see module docstring).
    """
    P, F = gm.w.shape
    M = z_rb.shape[0]
    dtype = gm.w.dtype

    pre = kalman_preupdate(pose, gm, cfg)            # [P, F] channels

    # --- association log-likelihood tensor [P, M, F] ---------------------
    innov_r = z_rb[None, :, None, 0] - pre.r[:, None, :]
    innov_b = wrap_angle(z_rb[None, :, None, 1] - pre.bearing[:, None, :])
    dist = (innov_r * innov_r * pre.si00[:, None, :]
            + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
            + innov_b * innov_b * pre.si11[:, None, :])
    dist = jnp.maximum(dist, 0.0)
    ln_n = -0.5 * dist - LOG_2PI - 0.5 * pre.log_det_s[:, None, :]

    in_fov = (pre.rclass == 1) & gm.valid            # [P, F]
    gate_ok = ((dist <= cfg.fastslamGate)
               & in_fov[:, None, :] & z_valid[None, :, None])

    log_pd = float(np.log(cfg.pd))
    log_qd = float(np.log(max(1.0 - cfg.pd, 1e-12)))
    log_kappa = float(np.log(max(cfg.clutterDensity, 1e-12)))

    # marginal benefit of pairing m with f vs leaving both unpaired; the
    # sum of chosen benefits + the constant missed-detection/clutter floor
    # is the exact joint association log-likelihood
    benefit = jnp.where(gate_ok, ln_n + (log_pd - log_qd), _NEG)

    if cfg.fastslamAssoc == 1:
        # private no-match columns: row m may always take column F + m at
        # the clutter/new-landmark likelihood (padding rows too — their
        # real columns are gated out by z_valid, so the private column is
        # their only live option and they park there harmlessly)
        dummy = jnp.where(jnp.eye(M, dtype=bool)[None, :, :],
                          log_kappa, _NEG)
        dummy = jnp.broadcast_to(dummy, (P, M, M))
        full = jnp.concatenate([benefit, dummy], axis=2)    # [P, M, F+M]
        col = jax.vmap(_auction_rows)(full)                 # [P, M]
        assigned = (col < F) & z_valid[None, :]
        a_feat = jnp.minimum(col, F - 1)
    else:
        # per-measurement gated ML; prefer no-match when even the best
        # feature loses to the clutter hypothesis
        best_f = jnp.argmax(benefit, axis=2)                # [P, M]
        best_v = jnp.max(benefit, axis=2)
        assigned = (best_v > log_kappa) & z_valid[None, :]
        # winner-takes-feature conflict resolution: when two measurements
        # pick the same feature, only the higher-likelihood one keeps it
        onehot = (best_f[:, :, None] == jnp.arange(F)[None, None, :]) \
            & assigned[:, :, None]
        v_mat = jnp.where(onehot, best_v[:, :, None], _NEG)
        winner = jnp.argmax(v_mat, axis=1)                  # [P, F]
        keep = winner[
            jnp.arange(P)[:, None],
            jnp.minimum(best_f, F - 1)] == jnp.arange(M)[None, :]
        assigned = assigned & keep
        a_feat = best_f

    # --- EKF update of matched features ----------------------------------
    hit = assigned[:, :, None] \
        & (a_feat[:, :, None] == jnp.arange(F)[None, None, :])  # [P, M, F]
    ir_f = jnp.sum(jnp.where(hit, innov_r, 0.0), axis=1)    # [P, F]
    ib_f = jnp.sum(jnp.where(hit, innov_b, 0.0), axis=1)
    matched = jnp.any(hit, axis=1)                           # [P, F]

    mx = jnp.where(matched, gm.mx + pre.g00 * ir_f + pre.g01 * ib_f, gm.mx)
    my = jnp.where(matched, gm.my + pre.g10 * ir_f + pre.g11 * ib_f, gm.my)
    c00 = jnp.where(matched, pre.u00, gm.c00)
    c01 = jnp.where(matched, pre.u01, gm.c01)
    c11 = jnp.where(matched, pre.u11, gm.c11)

    # evidence counter: +1 seen, -1 missed-in-FOV, delete at <= 0 (the
    # landmark-quality counter of FastSLAM practice; the reference skeleton
    # never got this far)
    w = jnp.where(matched, gm.w + 1.0,
                  jnp.where(in_fov, gm.w - 1.0, gm.w))
    dead = w <= 0.0
    w = jnp.where(dead, 0.0, w)
    c00 = jnp.where(dead, 1.0, c00)
    c01 = jnp.where(dead, 0.0, c01)
    c11 = jnp.where(dead, 1.0, c11)
    mx = jnp.where(dead, 0.0, mx)
    my = jnp.where(dead, 0.0, my)

    # --- particle weight: exact joint association log-likelihood ---------
    match_ben = jnp.sum(jnp.where(hit, benefit, 0.0), axis=(1, 2))  # [P]
    n_unmatched = jnp.sum(z_valid[None, :] & ~assigned, axis=1)
    dw = (jnp.sum(jnp.where(in_fov, log_qd, 0.0), axis=1)
          + match_ben
          + n_unmatched.astype(dtype) * log_kappa)

    # --- births from unmatched measurements ------------------------------
    bmean, bcov = birth_gaussian(pose[:, None, :], z_rb[None, :, :], cfg)
    bw = jnp.where(z_valid[None, :] & ~assigned, 1.0, 0.0).astype(dtype)
    all_w = jnp.concatenate([w, bw], axis=1)                 # [P, F+M]
    all_mx = jnp.concatenate([mx, bmean[..., 0]], axis=1)
    all_my = jnp.concatenate([my, bmean[..., 1]], axis=1)
    all_c00 = jnp.concatenate([c00, bcov[..., 0, 0]], axis=1)
    all_c01 = jnp.concatenate([c01, bcov[..., 0, 1]], axis=1)
    all_c11 = jnp.concatenate([c11, bcov[..., 1, 1]], axis=1)

    # weight-ranked union back to the padded [P, F] map (existing features
    # rank ahead of same-count births: top_k keeps the earlier index)
    _, idx = jax.lax.top_k(all_w, F)
    take = lambda a: jnp.take_along_axis(a, idx, axis=1)
    keep_w = take(all_w)
    live = keep_w > 0.0
    gm_out = Gaussian2DMixture(
        w=jnp.where(live, keep_w, 0.0),
        mx=jnp.where(live, take(all_mx), 0.0),
        my=jnp.where(live, take(all_my), 0.0),
        c00=jnp.where(live, take(all_c00), 1.0),
        c01=jnp.where(live, take(all_c01), 0.0),
        c11=jnp.where(live, take(all_c11), 1.0))
    return gm_out, dw


@partial(jax.jit, static_argnames=("cfg",))
def fastslam_update_jit(pose, gm, z_rb, z_valid, cfg):
    return fastslam_update(pose, gm, z_rb, z_valid, cfg)
