"""OSPA (Optimal SubPattern Assignment) metric.

Semantics of python/ospa.py:221-269 (the reference's evaluation metric,
used by python/batch_analyze.py:30 with p=1, c=5):

  - swap so |X| = m <= n = |Y|
  - cost matrix of Euclidean distances, cut off at c *before* assignment
  - optimal assignment (the reference uses a Cython Munkres; here the exact
    Jonker-Volgenant solver from scipy for host-side eval and a vectorized
    JAX auction algorithm for in-loop scoring on device)
  - ospa  = ((sum_assigned d^p + (n-m) c^p) / n)^(1/p)
    loc   = (sum_assigned d^p / n)^(1/p)
    card  = ((n-m) c^p / n)^(1/p)
  - empty/empty -> (0,0,0); one empty -> (c,0,c)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def ospa_np(x, y, p: float = 1.0, c: float = 10.0):
    """Exact OSPA on host via scipy's Jonker-Volgenant assignment.

    x [m,d], y [n,d] numpy arrays. Returns (ospa, loc, card).

    Uses the native C++ Jonker-Volgenant solver when built (native/), else
    scipy."""
    from scipy.optimize import linear_sum_assignment

    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    m, n = x.shape[0], y.shape[0]
    if m == 0 and n == 0:
        return 0.0, 0.0, 0.0
    if m == 0 or n == 0:
        return float(c), 0.0, float(c)
    if m > n:
        x, y = y, x
        m, n = n, m
    d = np.linalg.norm(x[:, None, :] - y[None, :, :], axis=-1)
    d = np.minimum(d, c)
    from phdslam_tpu import native
    if native.available():
        _, total_loc = native.hungarian(d ** p)
    else:
        rows, cols = linear_sum_assignment(d ** p)
        total_loc = float((d[rows, cols] ** p).sum())
    err_cn = (c ** p * (n - m) / n) ** (1.0 / p)
    err_loc = (total_loc / n) ** (1.0 / p)
    err = ((total_loc + (n - m) * c ** p) / n) ** (1.0 / p)
    return err, err_loc, err_cn


#: eps-optimality of the final scaling phase, in units of the (normalized
#: to [0, 1]) cost range: the auction terminates with total assignment cost
#: within n * EPS_FINAL of optimal (Bertsekas eps-complementary-slackness),
#: so after OSPA's division by n the metric error is bounded by
#: EPS_FINAL * c**p in absolute terms (5e-3 at the batch_analyze p=1, c=5).
_EPS_FINAL = 1e-3
_THETA = 4.0     # eps reduction factor between scaling phases
#: per-phase iteration budget, in multiples of n. With theta-scaling a
#: phase needs ~n*(theta+1) bids (each bid raises one price by >= eps, and
#: a phase only has to recover the ~n*theta*eps slack left by its
#: predecessor), so 16n covers theta=4 with ~3x headroom
#: (scripts/ospa_latency.py checks the metric gap against the exact
#: solution).
_BIDS_PER_N = 16


def _auction_assign(cost, max_iters: int = 0):
    """Jacobi (all-bidders-parallel) forward auction with eps-scaling for
    square min-cost assignment under jit — the data-parallel formulation:
    every unassigned row bids simultaneously, each column accepts its best
    bid, so one iteration is a handful of [n, n] elementwise ops instead of
    the sequential one-bid-per-trip Gauss-Seidel form.

    cost [n, n] with entries in [0, 1] (callers normalize by c**p).
    Returns owner[j] = row assigned to column j.

    Cost/termination contract:
      - scaling phases eps = theta^k * EPS_FINAL down to EPS_FINAL, each
        capped at _BIDS_PER_N * n iterations -> hard total bound
        O(n log(1/EPS_FINAL)) iterations of O(n^2) vector work;
      - if every phase converges (the observed case — see
        results/ospa_latency.json probes) the assignment satisfies
        eps-complementary slackness at EPS_FINAL;
      - if the budget is ever exhausted, remaining rows are paired with
        remaining columns arbitrarily, guaranteeing a *feasible* (possibly
        suboptimal) assignment rather than an unterminated loop.
    """
    n = cost.shape[0]
    benefit = -cost
    cols = jnp.arange(n)

    n_phases = max(1, int(np.ceil(np.log(0.25 / _EPS_FINAL)
                                  / np.log(_THETA))) + 1)
    eps_schedule = jnp.asarray(
        [_EPS_FINAL * _THETA ** (n_phases - 1 - k) for k in range(n_phases)],
        cost.dtype)
    phase_budget = max_iters or _BIDS_PER_N * n

    def phase_body(carry, eps):
        price = carry

        def cond(s):
            it, _, _, assigned = s
            return (~jnp.all(assigned)) & (it < phase_budget)

        def body(s):
            it, price, owner, assigned = s
            values = benefit - price[None, :]
            j_best = jnp.argmax(values, axis=1)
            v_best = jnp.take_along_axis(values, j_best[:, None], 1)[:, 0]
            v_second = jnp.max(values.at[cols, j_best].set(-jnp.inf), axis=1)
            v_second = jnp.where(jnp.isfinite(v_second), v_second, v_best)
            bid_inc = v_best - v_second + eps
            # column j accepts the highest bid among unassigned rows
            # targeting it (ties break to the lowest row index)
            bid_mat = jnp.where(
                (~assigned)[:, None] & (j_best[:, None] == cols[None, :]),
                bid_inc[:, None], -jnp.inf)
            col_bid = jnp.max(bid_mat, axis=0)
            col_bidder = jnp.argmax(bid_mat, axis=0)
            win = jnp.isfinite(col_bid)
            price = jnp.where(win, price + col_bid, price)
            owner = jnp.where(win, col_bidder, owner)
            # rows whose column was taken become unassigned implicitly:
            # recompute assignment from ownership
            assigned = jnp.zeros_like(assigned).at[
                jnp.where(owner >= 0, owner, n)].set(True, mode="drop")
            return it + 1, price, owner, assigned

        init = (jnp.array(0, jnp.int32), price,
                jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool))
        _, price, owner, assigned = jax.lax.while_loop(cond, body, init)
        return price, (owner, assigned)

    _, (owners, assigneds) = jax.lax.scan(phase_body,
                                          jnp.zeros((n,), cost.dtype),
                                          eps_schedule)
    owner, assigned = owners[-1], assigneds[-1]

    # feasibility cleanup: pair leftover unassigned rows with unowned
    # columns in index order (no-op when the auction converged)
    free_cols = jnp.where(owner < 0, size=n, fill_value=n)[0]
    row_rank = jnp.cumsum(~assigned) - 1
    target = jnp.where(~assigned, free_cols[jnp.clip(row_rank, 0, n - 1)], n)
    owner = owner.at[target].set(cols, mode="drop")
    return owner


@partial(jax.jit, static_argnames=("p", "c", "max_iters"))
def ospa_jax(x, x_valid, y, y_valid, p: float = 1.0, c: float = 10.0,
             max_iters: int = 0):
    """Fixed-shape OSPA on device with a JAX auction solver.

    x [Mx, d] with mask x_valid; y [My, d] with mask y_valid. Padded entries
    are treated as absent by pinning their pairwise cost to the cutoff c,
    which makes them behave exactly like the (n-m) dummy points in the OSPA
    definition. Returns (ospa, loc, card).

    max_iters is a PER-SCALING-PHASE auction budget, not a total: the
    eps-scaled auction runs ~5 phases (see _auction_assign), each capped at
    max_iters bids, so the total work bound is ~n_phases * max_iters
    iterations of O(n^2) vector ops. 0 (default) = the tuned
    _BIDS_PER_N * n per-phase cap.
    """
    mx, my = x.shape[0], y.shape[0]
    n = max(mx, my)

    # build padded square cost: real-real pairs get min(dist, c); any pair
    # involving a padded slot costs exactly c
    big_x = jnp.zeros((n, x.shape[1]), x.dtype).at[:mx].set(x)
    big_y = jnp.zeros((n, y.shape[1]), y.dtype).at[:my].set(y)
    vx = jnp.zeros((n,), bool).at[:mx].set(x_valid)
    vy = jnp.zeros((n,), bool).at[:my].set(y_valid)
    d = jnp.linalg.norm(big_x[:, None, :] - big_y[None, :, :], axis=-1)
    d = jnp.minimum(d, c)
    d = jnp.where(vx[:, None] & vy[None, :], d, c)
    # the auction works on costs normalized to [0, 1] so its eps schedule
    # and optimality bound are scale-free
    owner = _auction_assign(d ** p / c ** p, max_iters)

    cols = jnp.arange(n)
    m_count = jnp.minimum(jnp.sum(vx), jnp.sum(vy)).astype(x.dtype)
    n_count = jnp.maximum(jnp.sum(vx), jnp.sum(vy)).astype(x.dtype)
    cp = jnp.asarray(c ** p, x.dtype)
    # every padded-square pair except real-real costs exactly c^p, so the
    # real-assignment localization cost falls out of the total without
    # needing to know which optimum (real-real at cutoff vs routed through
    # padding slots — both cost c^p) the auction picked:
    #   total_loc = T - (N - m) c^p,  T = full padded assignment cost
    total_pad = jnp.sum(d[owner, cols] ** p)
    total_loc = jnp.maximum(total_pad - (n - m_count) * cp, 0.0)
    n_safe = jnp.maximum(n_count, 1.0)
    err = ((total_loc + (n_count - m_count) * cp) / n_safe) ** (1.0 / p)
    loc = (total_loc / n_safe) ** (1.0 / p)
    card = ((n_count - m_count) * cp / n_safe) ** (1.0 / p)
    # empty-set conventions
    both_empty = (m_count == 0) & (n_count == 0)
    one_empty = (m_count == 0) & (n_count > 0)
    err = jnp.where(both_empty, 0.0, jnp.where(one_empty, c, err))
    loc = jnp.where(both_empty | one_empty, 0.0, loc)
    card = jnp.where(both_empty, 0.0, jnp.where(one_empty, c, card))
    return err, loc, card
