"""Motion and measurement model tests, including ground-truth trajectory
reproduction from the shipped dataset."""

import pytest

import os

import numpy as np
import jax.numpy as jnp

from phdslam_tpu.config import load_config
from phdslam_tpu.io.loaders import load_trajectory
from phdslam_tpu.models import motion, measurement
from phdslam_tpu.utils import REPO_ROOT

CFG = load_config(os.path.join(REPO_ROOT, "cfg", "ackerman_synth.cfg"))


def test_ackerman_reproduces_ground_truth():
    """Noiseless Ackerman prediction with the seed scenario's true controls
    must reproduce its committed truth (data/ackerman_synth/traj.txt;
    scripts/gen_ackerman_data.py: seed 2, shifted to the cfg's start)."""
    from phdslam_tpu.simdata import make_scenario

    sc = make_scenario(np.random.default_rng(2), n_landmarks=80,
                       n_steps=330)
    traj = load_trajectory(os.path.join(REPO_ROOT, "data", "ackerman_synth",
                                        "traj.txt"))
    np.testing.assert_allclose(traj[:, :2], sc.traj[:, :2] + [0.0, -15.0],
                               atol=1e-5)
    us = sc.controls_true
    pose = jnp.asarray(np.concatenate([traj[0, :3], np.zeros(3)]),
                       jnp.float32)[None]
    errs = []
    for t in range(50):
        pose = motion.ackerman_predict(
            pose, (jnp.float32(us[t, 0]), jnp.float32(us[t, 1])),
            jnp.zeros((1, 2)), CFG, jnp.float32(1.0))
        errs.append(np.linalg.norm(np.asarray(pose[0, :2]) - traj[t + 1, :2]))
    assert max(errs) < 1e-3


def test_cv_predict_simple():
    pose = jnp.asarray([[0.0, 0.0, 0.0, 2.0, 0.0, 0.1]])
    new = motion.cv_predict(pose, jnp.zeros((1, 3)), 0.5)
    np.testing.assert_allclose(np.asarray(new[0]),
                               [1.0, 0.0, 0.05, 2.0, 0.0, 0.1], atol=1e-6)
    # heading rotates velocity direction
    pose2 = jnp.asarray([[0.0, 0.0, np.pi / 2, 2.0, 0.0, 0.0]])
    new2 = motion.cv_predict(pose2, jnp.zeros((1, 3)), 1.0)
    np.testing.assert_allclose(np.asarray(new2[0, :2]), [0.0, 2.0],
                               atol=1e-6)


def test_cv_feature_predict_cov():
    mean = jnp.asarray([1.0, 2.0, 0.5, -0.5])
    cov = jnp.eye(4)
    cfg = CFG.replace(stdAxMap=0.1, stdAyMap=0.2)
    m2, c2 = motion.cv_feature_predict(mean, cov, cfg, 2.0)
    np.testing.assert_allclose(np.asarray(m2), [2.0, 1.0, 0.5, -0.5],
                               atol=1e-6)
    f = np.eye(4)
    f[0, 2] = f[1, 3] = 2.0
    q = np.asarray(motion.cv_feature_q(2.0, 0.01, 0.04))
    expect = f @ np.eye(4) @ f.T + q
    np.testing.assert_allclose(np.asarray(c2), expect, rtol=1e-5)


def test_birth_gaussian_negative_range():
    """Negative-range measurements (present in the shipped data) must give
    finite birth covariances — dx/range == cos(theta) exactly."""
    pose = jnp.asarray([0.0, 0.0, 0.0])
    z = jnp.asarray([[-1.5, 0.3], [0.0, 0.1], [5.0, -0.4]])
    mean, cov = measurement.birth_gaussian(pose, z, CFG)
    assert np.isfinite(np.asarray(mean)).all()
    assert np.isfinite(np.asarray(cov)).all()
    # positive-range case matches the analytic form
    r, b = 5.0, -0.4
    j0, j1 = np.cos(b), np.sin(b)
    j2, j3 = -r * np.sin(b), r * np.cos(b)
    vr = (CFG.stdRange * CFG.birthNoiseFactor) ** 2
    vb = (CFG.stdBearing * CFG.birthNoiseFactor) ** 2
    c00 = j0 * j0 * vr + j2 * j2 * vb
    assert abs(float(cov[2, 0, 0]) - c00) < 1e-5


@pytest.mark.slow
def test_range_class():
    cfg = CFG  # maxRange 10, maxBearing pi/2, minRange 0
    pose = jnp.asarray([0.0, 0.0, 0.0])
    pts = jnp.asarray([[5.0, 0.0],    # in
                       [11.0, 0.0],   # near (<= 1.2*10)
                       [20.0, 0.0],   # out
                       [0.5, 5.0],    # bearing just under pi/2: in
                       [-3.0, -0.1]])  # behind: |b|>1.2*maxBearing -> out
    r, b, dx, dy, r2 = measurement.predict_measurement(pose, pts)
    rc = np.asarray(measurement.range_class(r, b, cfg))
    assert list(rc) == [1, 2, 0, 1, 0]


def test_jacobian_analytic():
    dx, dy = 3.0, 4.0
    r2 = 25.0
    r = 5.0
    j = np.asarray(measurement.measurement_jacobian(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(r), jnp.asarray(r2)))
    np.testing.assert_allclose(
        j, [[0.6, 0.8], [-0.16, 0.12]], atol=1e-7)
