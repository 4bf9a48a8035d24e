"""Locality-preserving distributed resampling: the island / butterfly model.

The plain multi-chip path (parallel/mesh.py) runs one global stratified
resample; XLA lowers the particle gather into all-to-all collectives that
move whole particle maps between chips every resampling step. This module
implements the alternative — the island particle model with
butterfly weight balancing (Vergé et al. 2013 island particle models;
Heine/Whiteley/Lee butterfly resampling):

  - Each shard ("island") of the particle axis runs the full SLAM step
    locally, including its own stratified resample — zero collective
    traffic for the per-step resample.
  - Each island carries a scalar island log-weight, updated by the island's
    local marginal likelihood increment (the logsumexp the single-chip step
    already computes). Cross-island quantities (expected pose, global nEff)
    are tiny scalar collectives.
  - When the island weights degenerate (island nEff below a threshold), a
    butterfly exchange runs: log2(n) rounds of static-stride
    `lax.ppermute` (stride 1, 2, 4, ...). In round r, island k merges its
    particle set with island k XOR stride: both islands' particles form a
    2x pool weighted by (island weight x particle weight), each island
    locally resamples its P_local particles from the pool, and the merged
    island weight becomes the pair average. After all rounds every island
    weight equals the global mean and every particle pool has globally
    mixed ancestry — the same stationary result as a global resample, but
    all traffic is fixed-stride neighbor ppermutes instead of a
    data-dependent all-to-all gather.

Exactness: island resampling targets the same distribution as the global
filter (the island weights carry exactly the mass a global resample would
have equalized); the butterfly rounds implement a proper resampling scheme
on the product space, so estimates stay unbiased. Variance behavior matches
the island-filter literature: slightly higher between-exchange variance,
traded for removing the all-to-all.

The reference has no distributed axis at all (SURVEY.md section 2.4); this
subsystem is new in the rebuild.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filter.state import Measurements, SlamState
from phdslam_tpu.ops.resample import stratified_resample_indices

AXIS = "islands"


class IslandAux(NamedTuple):
    expected_pose: jax.Array     # [6] global (island-weighted)
    island_logw: jax.Array       # [n] normalized island log-weights
    island_neff: jax.Array       # scalar in (0, 1]: nEff(islands)/n
    exchanged: jax.Array         # bool: butterfly ran this step
    log_lik: jax.Array           # scalar global marginal-likelihood incr.


class IslandLogAux(NamedTuple):
    """Per-step state for the state_estimate log contract in island scan
    mode. Per-island quantities stack on the island axis with NO extra
    collectives: each island emits its local-argmax particle's map
    ([n, F] after stacking) and the host picks the globally best island
    (argmax of best_score) when writing logs."""

    best_score: jax.Array        # [n] island_logw + max local particle lw
    best_w: jax.Array            # [n, F] that particle's static channels
    best_mx: jax.Array           # [n, F]
    best_my: jax.Array           # [n, F]
    best_c00: jax.Array          # [n, F]
    best_c01: jax.Array          # [n, F]
    best_c11: jax.Array          # [n, F]
    log_weights: jax.Array       # [P] global log weights (island + local)
    poses: jax.Array             # [P, 6]
    resample_idx: jax.Array      # [P]


def make_island_mesh(n_islands: int) -> Mesh:
    devs = jax.devices()
    if len(devs) < n_islands:
        raise RuntimeError(
            f"requested {n_islands} islands but only {len(devs)} devices "
            "exist; set jax.config.update('jax_num_cpu_devices', "
            f"{n_islands}) (or XLA_FLAGS=--xla_force_host_platform_"
            f"device_count={n_islands}) before initializing jax")
    return Mesh(np.asarray(devs[:n_islands]), (AXIS,))


def _butterfly_round(state: SlamState, island_logw_me, key, stride: int,
                     n_islands: int):
    """One butterfly exchange round at a static stride (inside shard_map).

    Pairs island k with island k XOR stride via two static ppermutes,
    pools both particle sets (2 x P_local) weighted by island weight x
    particle weight, and locally resamples P_local particles from the pool.
    """
    me = jax.lax.axis_index(AXIS)
    partner = me ^ stride
    perm = [(i, i ^ stride) for i in range(n_islands)]

    other_state = jax.tree.map(
        lambda x: jax.lax.ppermute(x, AXIS, perm), state)
    other_logw = jax.lax.ppermute(island_logw_me, AXIS, perm)

    # pooled particle log-weights: island logw + local (normalized) logw
    pool_lw = jnp.concatenate([
        state.log_weights + island_logw_me,
        other_state.log_weights + other_logw])
    pool = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                        state, other_state)

    p_local = state.log_weights.shape[0]
    # identical pair -> identical pool; decorrelate the two islands' draws
    key = jax.random.fold_in(key, jnp.minimum(me, partner))
    key = jax.random.fold_in(key, jnp.int32(stride))
    sub = jax.random.fold_in(key, me)
    idx = stratified_resample_indices(sub, pool_lw, p_local)
    new_lw = jnp.full((p_local,), -jnp.log(float(p_local)),
                      state.log_weights.dtype)
    new_state = jax.tree.map(lambda x: jnp.take(x, idx, axis=0), pool)
    new_state = new_state.replace(
        log_weights=new_lw,
        resample_idx=jnp.arange(p_local, dtype=jnp.int32))
    # merged island weight: average of the pair (total mass conserved)
    new_logw = jnp.logaddexp(island_logw_me, other_logw) - jnp.log(2.0)
    return new_state, new_logw


def island_slam_step(mesh: Mesh, cfg: SlamConfig,
                     island_resample_thresh: float = 0.5,
                     with_log_state: bool = False):
    """Build the jitted island-model SLAM step over `mesh`.

    Returns (step_fn, init_fn):
      init_fn() -> (state [sharded], island_logw [n])
      step_fn(state, island_logw, key, control, z, dt, do_predict)
          -> (state', island_logw', IslandAux)

    `cfg.n_particles` is the GLOBAL particle count; each island runs
    n_particles / n_islands. Requires nPredictParticles == 1 (the shotgun
    expansion would change local shapes).
    """
    from phdslam_tpu.filter.step import slam_step

    n = mesh.devices.size
    assert cfg.n_particles % n == 0, (cfg.n_particles, n)
    assert cfg.nPredictParticles == 1, \
        "island mode requires n_predict_particles == 1"
    p_local = cfg.n_particles // n
    # every island's step already runs inside this shard_map, so the
    # kernels (when the mesh's platform runs them) lower per shard
    from phdslam_tpu.parallel.mesh import resolve_pallas
    cfg, _ = resolve_pallas(cfg, mesh)
    cfg_local = cfg.replace(n_particles=p_local)
    rounds = []
    s = 1
    while s < n:
        rounds.append(s)
        s *= 2
    assert 1 << len(rounds) == n, f"n_islands must be a power of 2, got {n}"

    shard = NamedSharding(mesh, P(AXIS))

    state_spec = jax.tree.map(lambda _: P(AXIS), SlamState.create(cfg_local))
    zspec = jax.tree.map(lambda _: P(), Measurements(rb=0, label=0, valid=0))

    aux_spec = IslandAux(expected_pose=P(), island_logw=P(AXIS),
                         island_neff=P(), exchanged=P(), log_lik=P())
    out_specs = (state_spec, P(AXIS), aux_spec)
    if with_log_state:
        out_specs = out_specs + (IslandLogAux(*([P(AXIS)] * 10)),)

    @partial(shard_map, mesh=mesh,
             in_specs=(state_spec, P(AXIS), P(), P(), zspec, zspec, P(),
                       P()),
             out_specs=out_specs,
             check_vma=False)
    def _step(state, island_logw, key, control, z, z_prev, dt, do_predict):
        me = jax.lax.axis_index(AXIS)
        island_logw_me = island_logw[0]                       # [1] shard
        k_step, k_ex = jax.random.split(jax.random.fold_in(key, me))

        state, aux = slam_step(state, k_step, (control[0], control[1]),
                               z, dt, do_predict, cfg_local,
                               z_prev=z_prev)
        # the local normalizer IS the island's likelihood increment
        island_logw_me = island_logw_me + aux.log_lik

        # normalize island weights globally (scalar collective)
        lse = jax.lax.pmax(  # logsumexp over islands via max + psum
            island_logw_me, AXIS)
        lw_shift = island_logw_me - lse
        norm = jnp.log(jax.lax.psum(jnp.exp(lw_shift), AXIS))
        island_logw_me = lw_shift - norm
        log_lik_global = lse + norm

        # island nEff (replicated scalar)
        neff_i = 1.0 / (jax.lax.psum(jnp.exp(2.0 * island_logw_me), AXIS)
                        * n)

        # global expected pose: island-weighted psum of local estimates
        exp_pose = jax.lax.psum(
            jnp.exp(island_logw_me) * aux.expected_pose, AXIS)

        # butterfly exchange when islands degenerate (replicated predicate)
        def do_exchange(args):
            st, lw = args
            for stride in rounds:
                st, lw = _butterfly_round(st, lw, k_ex, stride, n)
            return st, lw

        trigger = neff_i <= island_resample_thresh
        state, island_logw_me = jax.lax.cond(
            trigger, do_exchange, lambda a: a, (state, island_logw_me))

        aux_out = IslandAux(
            expected_pose=exp_pose,
            island_logw=jnp.reshape(island_logw_me, (1,)),
            island_neff=neff_i, exchanged=trigger,
            log_lik=log_lik_global)
        outs = (state, jnp.reshape(island_logw_me, (1,)), aux_out)
        if with_log_state:
            best = jnp.argmax(state.log_weights)
            ms = state.map_static
            la = IslandLogAux(
                best_score=jnp.reshape(
                    island_logw_me + state.log_weights[best], (1,)),
                best_w=ms.w[best][None], best_mx=ms.mx[best][None],
                best_my=ms.my[best][None], best_c00=ms.c00[best][None],
                best_c01=ms.c01[best][None], best_c11=ms.c11[best][None],
                log_weights=island_logw_me + state.log_weights,
                poses=state.pose,
                resample_idx=state.resample_idx)
            outs = outs + (la,)
        return outs

    def init():
        state = SlamState.create(cfg)
        state = jax.device_put(
            state, jax.tree.map(
                lambda _: NamedSharding(mesh, P(AXIS)), state))
        island_logw = jax.device_put(
            jnp.full((n,), -jnp.log(float(n)), jnp.float32), shard)
        return state, island_logw

    jit_step = jax.jit(_step, donate_argnums=(0,))

    def step(state, island_logw, key, control, z, dt, do_predict,
             z_prev=None):
        if z_prev is None:
            # empty previous measurement set (CPHD births come from
            # z_prev; all-invalid == none)
            z_prev = jax.tree.map(jnp.zeros_like, z)
        return jit_step(state, island_logw, key, control, z, z_prev, dt,
                        do_predict)

    step.jitted = jit_step   # for .lower() / HLO inspection (tests)
    return step, init


def island_run_scan(mesh: Mesh, cfg: SlamConfig,
                    island_resample_thresh: float = 0.5,
                    with_log_state: bool = False):
    """Whole-dataset `lax.scan` over the island step (the distributed analog
    of filter.step.run_scan — one dispatch for the full run).

    Returns (run_fn, init_fn):
      run_fn(state, island_logw, key, controls [T,2], zs (leading T),
             dts [T]) -> (state', island_logw', stacked IslandAux) — plus a
      stacked IslandLogAux when `with_log_state` (for the per-step
      state_estimate log contract).
    """
    step, init = island_slam_step(mesh, cfg, island_resample_thresh,
                                  with_log_state=with_log_state)

    @jax.jit
    def run(state, island_logw, key, controls, zs, dts):
        length = controls.shape[0]
        keys = jax.random.split(key, length)
        t_idx = jnp.arange(length)
        # previous-step measurements (CPHD births): shift by one
        zs_prev = jax.tree.map(
            lambda x: jnp.concatenate(
                [jnp.zeros_like(x[:1]), x[:-1]], axis=0), zs)

        def body(carry, inp):
            st, ilw = carry
            k, ctrl, z, zp, dt, t = inp
            outs = step(st, ilw, k, ctrl, z, dt, t > 0, z_prev=zp)
            st, ilw = outs[0], outs[1]
            return (st, ilw), outs[2:]

        (state_f, ilw_f), auxs = jax.lax.scan(
            body, (state, island_logw),
            (keys, controls, zs, zs_prev, dts, t_idx))
        if with_log_state:
            return state_f, ilw_f, auxs[0], auxs[1]
        return state_f, ilw_f, auxs[0]

    return run, init
