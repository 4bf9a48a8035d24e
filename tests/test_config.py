"""Config-system tests: the parser must accept the reference cfg verbatim."""

import math
import os

import pytest

from phdslam_tpu.config import SlamConfig, load_config, parse_config_text
from phdslam_tpu.utils import REPO_ROOT

# the reference program's own cfg/config.cfg, from a checkout of it
REF_CFG = os.path.join(os.environ.get("CUDA_PHDSLAM_DIR", ""), "cfg",
                       "config.cfg")
SHIPPED_CFG = os.path.join(REPO_ROOT, "cfg", "ackerman_synth.cfg")


def test_reference_config_verbatim():
    if not os.path.exists(REF_CFG):
        pytest.skip("the reference program's cfg/config.cfg is not found "
                    "(set CUDA_PHDSLAM_DIR to its checkout)")
    cfg = load_config(REF_CFG)
    # values straight from cfg/config.cfg
    assert cfg.motionType == 1
    assert cfg.maxRange == 15.0
    assert abs(cfg.maxBearing - 3.141593) < 1e-6
    assert cfg.stdRange == 0.25
    assert abs(cfg.stdBearing - 0.008727) < 1e-9
    assert cfg.clutterRate == 20.0
    assert cfg.pd == 0.95
    assert cfg.l == 1.415 and cfg.h == 0.38
    assert cfg.a == 1.89 and cfg.b == 0.5
    assert cfg.stdEncoder == 1.0
    assert cfg.n_particles == 200
    assert cfg.birthWeight == 0.0001
    assert cfg.minSeparation == 10
    assert cfg.maxFeatures == 100
    assert cfg.minFeatureWeight == 1e-6
    assert cfg.particleWeighting == 0
    assert cfg.filterType == 0
    assert cfg.maxCardinality == 255
    assert cfg.mapEstimate == 0
    assert cfg.tau == -10      # later assignment wins (like program_options
    assert cfg.ps == 0.95      # last-value semantics for duplicate keys)
    assert not cfg.labeledMeasurements
    assert cfg.particlesPerFeature == 150
    assert cfg.imageWidth == 800 and cfg.imageHeight == 600
    assert cfg.fx == -895.6561


def test_derived_clutter_density():
    cfg = load_config(SHIPPED_CFG)
    assert cfg.clutterRate == 20.0 and cfg.maxRange == 10.0
    expect = cfg.clutterRate / (2 * cfg.maxBearing * cfg.maxRange)
    assert abs(cfg.clutterDensity - expect) < 1e-9
    # replace() re-derives
    cfg2 = cfg.replace(maxRange=30.0)
    assert abs(cfg2.clutterDensity - cfg.clutterRate
               / (2 * cfg.maxBearing * 30.0)) < 1e-9


def test_comments_and_unknown_keys():
    cfg = parse_config_text(
        "# full comment\n"
        "pd = 0.9  # trailing comment\n"
        "unknown_key = 42\n"
        "\n"
        "n_particles = 7\n")
    assert cfg.pd == 0.9
    assert cfg.n_particles == 7


def test_bool_coercion():
    cfg = parse_config_text("save_all_maps=1\ngate_births = false\n")
    assert cfg.saveAllMaps is True
    assert cfg.gateBirths is False


def test_defaults_match_reference():
    # defaults per the boost option table (src/main.cpp:960-1049)
    cfg = SlamConfig()
    assert cfg.pd == 0.98
    assert cfg.n_particles == 512
    assert cfg.resampleThresh == 0.15
    assert cfg.birthNoiseFactor == 1.5
    assert cfg.maxCardinality == 256
    assert cfg.filterType == 1
    assert cfg.motionType == 1
