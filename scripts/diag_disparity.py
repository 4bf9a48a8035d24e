"""One-off diagnostic for the disparity end-run drift (VERDICT r3 item 7).

Runs the shipped scenario once and prints, every 5 steps: expected-pose
error, neff, and the MAP particle's feature census (count above
minExpectedFeatureWeight, total intensity mass, in/out-of-FOV mass split,
count of "duplicate" features whose cloud means sit within 0.5 m of a
higher-weight feature).

Usage: python scripts/diag_disparity.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.disparity import DisparityState, disparity_step
    from phdslam_tpu.io.loaders import load_measurements, \
        pad_measurement_sets
    from phdslam_tpu.utils import configure_compile_cache

    configure_compile_cache()
    cfg = load_config("cfg/disparity_synth.cfg")
    sets = load_measurements("data/disparity_synth/measurements.txt")
    rb, _, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    truth = np.loadtxt("data/disparity_synth/traj.txt", comments="%")
    lms = np.loadtxt("data/disparity_synth/landmarks.txt", comments="%")
    T = len(sets)

    state = DisparityState.create(cfg)
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    jitter = jax.random.uniform(k0, (cfg.n_particles, 2),
                                minval=-0.03, maxval=0.03)
    state = state.replace(pose=state.pose.at[:, 3].add(jitter[:, 0])
                          .at[:, 5].add(jitter[:, 1]))

    print(f"{'t':>3} {'err':>6} {'neff':>6} {'nfeat':>5} {'mass':>6} "
          f"{'massIF':>6} {'massOF':>6} {'ndup':>4} {'dmin':>6} {'dmax':>6}")
    for t in range(T):
        key, sk = jax.random.split(key)
        state, aux = disparity_step(
            state, sk, jnp.asarray(rb[t]), jnp.asarray(valid[t]),
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
        if t % 5 and t != T - 1:
            continue
        ep = np.asarray(aux.expected_pose)
        err = np.linalg.norm(ep[:3] - truth[t, :3])
        mi = int(np.argmax(np.asarray(state.log_weights)))
        w = np.asarray(state.w[mi])
        sel = w > 0
        mean = np.stack([np.asarray(state.px[mi]).mean(-1),
                         np.asarray(state.py[mi]).mean(-1),
                         np.asarray(state.pz[mi]).mean(-1)], -1)
        # in-FOV test in the *true* camera frame: just use z>0 and pixel
        # projection with the MAP pose
        from phdslam_tpu.models.camera import world_to_disparity
        pu, pv, pdp, _ = world_to_disparity(
            jnp.asarray(mean[:, 0])[None, :, None],
            jnp.asarray(mean[:, 1])[None, :, None],
            jnp.asarray(mean[:, 2])[None, :, None],
            jnp.asarray(np.asarray(state.pose[mi]))[None, None, None, :],
            cfg)
        pu = np.asarray(pu)[0, :, 0]
        pv = np.asarray(pv)[0, :, 0]
        pdd = np.asarray(pdp)[0, :, 0]
        infov = (pu > 0) & (pu <= cfg.imageWidth) & (pv >= 0) \
            & (pv <= cfg.imageHeight) & (pdd >= 0)
        mass_if = float(w[sel & infov].sum())
        mass_of = float(w[sel & ~infov].sum())
        nfeat = int((w > cfg.minExpectedFeatureWeight).sum())
        # duplicates: features within 0.5 m of a higher-weight feature
        idx = np.argsort(-w)
        ndup = 0
        for a in range(len(idx)):
            ia = idx[a]
            if w[ia] <= cfg.minExpectedFeatureWeight:
                break
            for b in range(a):
                ib = idx[b]
                if np.linalg.norm(mean[ia] - mean[ib]) < 0.5:
                    ndup += 1
                    break
        # distance of estimated features to nearest true landmark
        if sel.sum():
            dmat = np.linalg.norm(
                mean[w > cfg.minExpectedFeatureWeight][:, None] - lms[None],
                axis=-1)
            dmin = float(dmat.min(1).min()) if dmat.size else np.nan
            dmax = float(dmat.min(1).max()) if dmat.size else np.nan
        else:
            dmin = dmax = np.nan
        print(f"{t:>3} {err:6.3f} {float(np.asarray(aux.neff)):6.1f} "
              f"{nfeat:5d} {float(w.sum()):6.2f} {mass_if:6.2f} "
              f"{mass_of:6.2f} {ndup:4d} {dmin:6.3f} {dmax:6.3f}")


if __name__ == "__main__":
    main()
