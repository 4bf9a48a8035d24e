"""Loader and log-format tests against the committed seed dataset
(data/ackerman_synth, written by scripts/gen_ackerman_data.py)."""

import os

import numpy as np

from phdslam_tpu.io import loaders, logs
from phdslam_tpu.utils import REPO_ROOT

SEED = os.path.join(REPO_ROOT, "data", "ackerman_synth")


def test_load_ackerman_measurements():
    sets = loaders.load_measurements(os.path.join(SEED, "measurements.txt"))
    assert len(sets) == 331
    assert len(sets[0].ranges) == 33
    assert abs(sets[0].ranges[0] - 2.260025) < 1e-6
    assert abs(sets[0].bearings[0] + 0.268964) < 1e-6
    # some shipped measurements are negative-range (Gaussian noise on
    # near-zero ranges) — the loaders must pass them through untouched
    allr = np.concatenate([s.ranges for s in sets])
    assert (allr < 0).any()


def test_load_cv_measurements():
    from phdslam_tpu.config import load_config

    cfg = load_config(os.path.join(REPO_ROOT, "cfg", "cv_synth.cfg"))
    sets = loaders.load_measurements(
        os.path.join(cfg.dataDirectory, "measurements.txt"))
    assert len(sets) == 331


def test_load_controls():
    c = loaders.load_controls(os.path.join(SEED, "controls.txt"))
    assert c.shape == (330, 2)
    assert abs(c[0, 0] - 1.44792) < 1e-5
    assert abs(c[0, 1] - 0.250593) < 1e-6


def test_load_controls_comma_separated(tmp_path):
    p = tmp_path / "controls.txt"
    p.write_text("% header\n1.5, 0.2\n-0.3, 0.1\n")
    c = loaders.load_controls(str(p))
    assert c.shape == (2, 2)
    assert c[1, 0] == np.float32(-0.3)


def test_load_timestamps_missing():
    assert loaders.load_timestamps("/nonexistent/times.txt") is None


def test_pad_measurement_sets():
    sets = loaders.load_measurements(os.path.join(SEED, "measurements.txt"))
    rb, labels, valid = loaders.pad_measurement_sets(sets[:10], 64)
    assert rb.shape == (10, 64, 2)
    assert valid[0].sum() == 33
    assert (rb[0, 33:] == 0).all()


def test_state_estimate_log_roundtrip(tmp_path):
    n, f = 4, 3
    pose = np.array([1.5, -2.0, 0.3, 0, 0, 0])
    w = np.array([0.9, 0.0, 0.4])          # zero-weight slot skipped
    mean = np.arange(f * 2).reshape(f, 2).astype(float)
    cov = np.tile(np.eye(2) * 0.5, (f, 1, 1))
    lw = np.full(n, -np.log(n))
    poses = np.tile(pose, (n, 1))
    path = logs.write_state_estimate_log(
        str(tmp_path), 7, pose, w, mean, cov,
        particle_log_weights=lw, particle_poses=poses,
        resample_idx=np.arange(n), max_cardinality=10)
    assert path.endswith("state_estimate00007.log")
    d = logs.read_state_estimate_log(path)
    assert np.allclose(d["pose"], pose)
    assert d["static"].shape == (2, 7)      # 2 nonzero-weight features
    assert np.allclose(d["static"][:, 0], [0.9, 0.4])
    # batch_analyze.py stride-7 contract: w, mx, my, cov4
    assert np.allclose(d["static"][0, 1:3], mean[0])
    assert d["weights"].shape == (n,)
    assert d["poses"].shape == (n, 6)
    assert d["cardinality"].shape == (11,)
    assert (d["cardinality"] == 0).all()


def test_log_shotgun_padding(tmp_path):
    """At t=0 weights/poses lines repeat nPredictParticles times
    (src/main.cpp:902-910)."""
    pose = np.zeros(6)
    lw = np.array([-0.7, -0.7])
    poses = np.zeros((2, 6))
    path = logs.write_state_estimate_log(
        str(tmp_path), 0, pose, np.zeros(0), np.zeros((0, 2)),
        np.zeros((0, 2, 2)), particle_log_weights=lw, particle_poses=poses,
        resample_idx=np.arange(2), max_cardinality=3, repeat=3)
    d = logs.read_state_estimate_log(path)
    assert d["weights"].shape == (6,)
    assert d["poses"].shape == (6, 6)


def test_state_estimate_log_roundtrip_disparity(tmp_path):
    """Disparity logs (12-DOF camera pose, 3-D feature Gaussians) are
    auto-detected by the reader: stride-13 map rows, 12-wide particle
    poses."""
    n, f = 3, 2
    pose = np.arange(12, dtype=float) * 0.1
    w = np.array([0.8, 0.6])
    mean = np.array([[400.0, 300.0, 200.0], [100.0, 150.0, 250.0]])
    cov = np.tile(np.diag([25.0, 25.0, 4900.0]), (f, 1, 1))
    lw = np.full(n, -np.log(n))
    poses = np.tile(pose, (n, 1))
    path = logs.write_state_estimate_log(
        str(tmp_path), 3, pose, w, mean, cov,
        particle_log_weights=lw, particle_poses=poses,
        resample_idx=np.arange(n), max_cardinality=10)
    d = logs.read_state_estimate_log(path)
    assert np.allclose(d["pose"], pose)
    assert d["static"].shape == (f, 13)
    assert np.allclose(d["static"][:, 0], w)
    assert np.allclose(d["static"][0, 1:4], mean[0])
    assert np.allclose(d["static"][0, 4:].reshape(3, 3).T, cov[0])
    assert d["poses"].shape == (n, 12)


class _FakeMix:
    def __init__(self, w, mean, cov):
        import numpy as _np
        self.w, self.mean, self.cov = (_np.asarray(a) for a in (w, mean, cov))
        self.max_features = self.w.shape[1]


class _FakeState:
    """Minimal SlamState stand-in for the .mat export contract tests."""

    def __init__(self, n=4, f2=3, f4=2, rng_seed=0):
        rng = np.random.default_rng(rng_seed)
        self.pose = rng.normal(size=(n, 6))
        self.log_weights = np.log(rng.dirichlet(np.ones(n)))
        self.variances = rng.random(n)
        self.resample_idx = np.arange(n)
        w2 = rng.random((n, f2 + 1))
        w2[:, -1] = 0.0                       # one empty (padded) slot
        c2 = np.tile(np.diag([0.5, 0.25]), (n, f2 + 1, 1, 1))
        c2[..., 0, 1] = c2[..., 1, 0] = 0.1
        self.map_static = _FakeMix(w2, rng.normal(size=(n, f2 + 1, 2)), c2)
        w4 = rng.random((n, f4))
        c4 = np.tile(np.eye(4), (n, f4, 1, 1))
        c4[..., 0, 2] = 0.3                   # asymmetric marker: tests the
        c4[..., 2, 0] = 0.7                   # column-major slice layout
        self.map_dynamic = _FakeMix(w4, rng.normal(size=(n, f4, 4)), c4)


def test_particles_mat_matlab_contract(tmp_path):
    """Parse particlesXXXXX.mat exactly as matlab/computeBatchResults.m:44-66
    does: scalar struct 'particles' with the ten writeParticlesMat fields
    (src/main.cpp:694-713), per-particle mixtures as 1xN struct arrays
    indexed maps_static(idx_max), and write_map_mat dims (1xF / dxF / dxdxF,
    src/main.cpp:534-546)."""
    from scipy.io import loadmat

    from phdslam_tpu.io.matdump import write_particles_mat

    st = _FakeState()
    n = 4
    mm = (np.array([0.9]), np.array([[1.0, 2.0]]),
          np.array([[[1.0, 0.2], [0.2, 2.0]]]))
    path = write_particles_mat(str(tmp_path), 12, st, max_map_static=mm)
    assert path.endswith("particles00012.mat")

    d = loadmat(path, squeeze_me=False)   # MATLAB 'load' equivalent
    p = d["particles"][0, 0]
    # all ten reference fields present (src/main.cpp:694-698)
    for name in ("states", "weights", "vars", "maps_static", "maps_dynamic",
                 "resample_idx", "max_map_static", "max_map_dynamic",
                 "exp_map_static", "exp_map_dynamic"):
        assert name in p.dtype.names, name

    particle_weights = p["weights"]            # 1 x N double
    particle_poses = p["states"]               # 6 x N double
    assert particle_weights.shape == (1, n)
    assert particle_poses.shape == (6, n)
    assert p["vars"].shape == (1, n)
    assert p["resample_idx"].shape == (1, n)
    assert p["resample_idx"].dtype == np.int32

    # computeBatchResults.m:48 — [w_max,idx_max] = max(particles.weights)
    idx_max = int(np.argmax(particle_weights))
    # :53-54 — expectedTraj = sum(poses .* exp(weights), 2)
    traj = (particle_poses * np.exp(particle_weights)).sum(axis=1)
    assert np.allclose(
        traj, (st.pose * np.exp(st.log_weights)[:, None]).sum(0))

    # :56-58 — particles.maps_static(idx_max).{weights,means,covs}
    ms = p["maps_static"]
    assert ms.shape == (1, n)                  # 1 x N struct array
    e = ms[0, idx_max]
    f2 = 3                                     # padded empty slot dropped
    assert e["weights"].shape == (1, f2)
    assert e["means"].shape == (2, f2)
    assert e["covs"].shape == (2, 2, f2)
    assert np.allclose(e["covs"][:, :, 0],
                       np.asarray(st.map_static.cov)[idx_max, 0])

    # :60-62 — maps_dynamic(idx_max): 4-D features, covs(:,:,j) must equal
    # the j-th 4x4 covariance (col-major slices like Gaussian4D.cov[16])
    md = p["maps_dynamic"][0, idx_max]
    assert md["means"].shape == (4, 2)
    assert md["covs"].shape == (4, 4, 2)
    assert md["covs"][0, 2, 0] == 0.3 and md["covs"][2, 0, 0] == 0.7

    # MAP estimate struct is 1x1 and filled; EAP left empty (flag off)
    assert p["max_map_static"].shape == (1, 1)
    assert np.allclose(p["max_map_static"][0, 0]["covs"][:, :, 0], mm[2][0])
    assert p["exp_map_static"][0, 0]["weights"].size == 0


def test_state_log_dynamic_stride21_matlab(tmp_path):
    """Dynamic map-line contract of matlab/computeBatchResults.m:89-119:
    21 floats per feature — w, mean(4), then the 16 cov entries column-major
    (c11 c21 c31 c41 c12 ...)."""
    pose = np.zeros(6)
    w4 = np.array([0.9])
    mean4 = np.array([[1.0, 2.0, 0.1, -0.2]])
    cov4 = np.arange(16, dtype=float).reshape(1, 4, 4)  # asymmetric marker
    path = logs.write_state_estimate_log(
        str(tmp_path), 5, pose, np.zeros(0), np.zeros((0, 2)),
        np.zeros((0, 2, 2)),
        dynamic_w=w4, dynamic_mean=mean4, dynamic_cov=cov4,
        particle_log_weights=np.zeros(1), particle_poses=np.zeros((1, 6)),
        resample_idx=np.zeros(1, int), max_cardinality=4)
    with open(path) as f:
        lines = f.read().splitlines()
    vals = np.array([float(v) for v in lines[2].split()])
    assert vals.size == 21
    # map_cell{1} = weight, {2..5} = means
    assert vals[0] == 0.9 and np.allclose(vals[1:5], mean4[0])
    # map_covs(i,j,:) = map_cell{5 + j*4 + i} — column-major order
    matlab_cov = vals[5:].reshape(4, 4, order="F")
    assert np.allclose(matlab_cov, cov4[0])
