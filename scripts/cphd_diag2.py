"""CPHD collapse diagnosis, part 2: population-level mass statistics.

cphd_diag.py reads the per-step argmax-weight particle, whose identity
churns; this script steps the filter manually and records, per step and
over ALL particles:

  - in-FOV intensity mass: weight-averaged, max, and the mass of the
    highest-weight particle
  - the rank-correlation between particle log-weight and in-FOV mass
    (does the CPHD multi-object likelihood favor or punish mapping?)

for BOTH filterType=1 (CPHD) and filterType=0 (PHD, same data/settings) —
the discriminator between "CPHD-specific suppression" and
"scenario-inherent" on the shipped Ackerman dataset.

Run: python scripts/cphd_diag2.py [T]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from phdslam_tpu.utils import configure_compile_cache

configure_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phdslam_tpu.config import load_config  # noqa: E402
from eval_baselines import load_ackerman  # noqa: E402


def main():
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import slam_step
    from phdslam_tpu.io.loaders import pad_measurement_sets

    traj, us, ms, gt = load_ackerman()
    rng = np.random.default_rng(3)
    noisy = (us[: T - 1] + rng.normal(0, (0.2, 0.01), (T - 1, 2))
             ).astype(np.float32)

    base = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=1024, maxCardinality=127,
        gateBirths=True, gateThreshold=9.0, mapEstimate=2)
    M = base.maxMeasurements
    rb_all, lab_all, val_all = pad_measurement_sets(ms[:T], M)

    @jax.jit
    def mass_stats(pose, w, mx, my, lw):
        """Per-particle in-FOV intensity mass + summary stats."""
        dx = mx - pose[:, None, 0]
        dy = my - pose[:, None, 1]
        r = jnp.hypot(dx, dy)
        b = jnp.arctan2(dy, dx) - pose[:, None, 2]
        b = jnp.arctan2(jnp.sin(b), jnp.cos(b))
        in_r = ((r >= base.minRange) & (r <= base.maxRange)
                & (jnp.abs(b) <= base.maxBearing))
        m_in = jnp.sum(w * in_r, axis=1)                       # [P]
        pw = jax.nn.softmax(lw)
        return (jnp.sum(pw * m_in), jnp.max(m_in),
                m_in[jnp.argmax(lw)], m_in)

    out = {}
    for name, ft in (("cphd", 1), ("phd", 0)):
        cfg = base.replace(filterType=ft)
        state = SlamState.create(cfg)
        key = jax.random.PRNGKey(0)
        rows = []
        z_prev = None
        for t in range(T):
            key, sk = jax.random.split(key)
            z = Measurements(rb=jnp.asarray(rb_all[t]),
                             label=jnp.asarray(lab_all[t]),
                             valid=jnp.asarray(val_all[t]))
            u = ((jnp.float32(noisy[t - 1, 0]), jnp.float32(noisy[t - 1, 1]))
                 if t > 0 else (jnp.float32(0), jnp.float32(0)))
            state, _aux = slam_step(state, sk, u, z, jnp.float32(cfg.dt),
                                    jnp.asarray(t > 0), cfg,
                                    z_prev=z_prev if ft == 1 else None)
            z_prev = z
            mean_m, max_m, map_m, m_in = mass_stats(
                state.pose, state.map_static.w, state.map_static.mx,
                state.map_static.my, state.log_weights)
            m_in = np.asarray(m_in)
            lw = np.asarray(state.log_weights)
            rk = float(np.corrcoef(np.argsort(np.argsort(lw)),
                                   np.argsort(np.argsort(m_in)))[0, 1]) \
                if m_in.std() > 1e-9 else float("nan")
            rows.append(dict(t=t, mean=float(mean_m), max=float(max_m),
                             map=float(map_m), rankcorr=rk))
            if t % 10 == 0 or t == T - 1:
                print(f"{name} t={t:3d} inFOV mass: wmean {mean_m:6.2f} "
                      f"max {max_m:6.2f} MAPpart {map_m:6.2f} "
                      f"rank(lw,mass) {rk:+.2f}", flush=True)
        out[name] = rows

    with open("results/cphd_diag2.json", "w") as f:
        json.dump(out, f)
    for name in out:
        tail = out[name][-30:]
        print(f"{name}: last-30 wmean {np.mean([r['mean'] for r in tail]):.2f}"
              f" max {np.mean([r['max'] for r in tail]):.2f}"
              f" rankcorr {np.nanmean([r['rankcorr'] for r in tail]):+.2f}")


if __name__ == "__main__":
    main()
