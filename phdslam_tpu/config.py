"""Configuration system.

Accepts the reference's ``key = value`` config dialect verbatim (the same
~75 keys parsed by boost::program_options in the reference's
``src/main.cpp:956-1073``), including ``#`` comments, blank lines, and
unknown-key tolerance. Derived quantity ``clutter_density`` follows
``src/main.cpp:1064-1066``:  clutterRate / (2 * maxBearing * maxRange).

The config is a frozen dataclass so it can be closed over by jit-compiled
functions as a static value (the moral equivalent of the reference's
``__constant__ SlamConfig dev_config``, ``src/phdfilter.cu:121``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


# Filter type (reference src/slamtypes.h:22-23)
PHD_TYPE = 0
CPHD_TYPE = 1
# Rebuild extension: the working realization of the reference's
# vestigial FastSLAM subsystem (src/fastslam.cu, src/munkres.cu — neither
# compiles nor is in the build; see filter/fastslam.py)
FASTSLAM_TYPE = 2
# Motion type (src/slamtypes.h:24-25)
CV_MOTION = 0
ACKERMAN_MOTION = 1
# Feature models (src/slamtypes.h:28-30)
STATIC_MODEL = 0
DYNAMIC_MODEL = 1
MIXED_MODEL = 2
# Measurement labels (src/slamtypes.h:32-33)
STATIC_MEASUREMENT = 0
DYNAMIC_MEASUREMENT = 1

# log(0) stand-in, matching the reference's LOG0 = -FLT_MAX
# (src/slamtypes.h:26). Used for log-space weights of empty slots.
LOG0 = -3.4028235e38


@dataclass(frozen=True)
class SlamConfig:
    """Mirror of the reference SlamConfig (src/slamtypes.h:142-250).

    Field names keep the reference's camelCase so citations line up; the
    cfg-file keys (snake_case) are mapped in ``_KEY_MAP`` below, matching
    the option table in src/main.cpp:960-1049.
    """

    debug: bool = False

    # initial state
    x0: float = 0.0
    y0: float = 0.0
    z0: float = 0.0
    roll0: float = 0.0
    pitch0: float = 0.0
    yaw0: float = 0.0
    vx0: float = 0.0
    vy0: float = 0.0
    vz0: float = 0.0
    vroll0: float = 0.0
    vpitch0: float = 0.0
    vyaw0: float = 0.0

    followTrajectory: bool = False

    # constant-velocity pose process noise (std of accelerations)
    ax: float = 0.5
    ay: float = 0.0
    az: float = 0.0
    aroll: float = 0.0087
    apitch: float = 0.0087
    ayaw: float = 0.0087
    dt: float = 0.1

    # range-bearing sensor
    minRange: float = 0.0
    maxRange: float = 20.0
    maxBearing: float = math.pi
    stdRange: float = 1.0
    stdBearing: float = 0.0524
    clutterRate: float = 15.0
    pd: float = 0.98

    # feature process noise
    stdVxMap: float = 0.0
    stdVyMap: float = 0.0
    stdAxMap: float = 0.0
    stdAyMap: float = 0.0
    covVxBirth: float = 0.0
    covVyBirth: float = 0.0
    ps: float = 0.98

    # jump-markov parameters
    tau: float = 0.0
    beta: float = 1.0

    # camera / disparity
    particlesPerFeature: int = 100
    imageWidth: int = 600
    imageHeight: int = 480
    stdU: float = 1.0
    stdV: float = 1.0
    disparityBirth: float = 1000.0
    stdDBirth: float = 300.0
    fx: float = 1000.0
    fy: float = 1000.0
    u0: float = 512.0
    v0: float = 384.0

    # particle filter
    n_particles: int = 512
    nPredictParticles: int = 1
    subdividePredict: int = 1
    resampleThresh: float = 0.15
    birthWeight: float = 0.05
    birthNoiseFactor: float = 1.5
    gateBirths: bool = True
    gateMeasurements: bool = True
    gateThreshold: float = 10.0
    minExpectedFeatureWeight: float = 0.33
    minSeparation: float = 5.0
    maxFeatures: int = 100
    minFeatureWeight: float = 1e-5
    particleWeighting: int = 1
    daughterMixtureType: int = 0
    nSamples: int = 50
    maxCardinality: int = 256
    filterType: int = 1
    distanceMetric: int = 0
    maxSteps: int = 10000
    featureModel: int = 0
    motionType: int = ACKERMAN_MOTION
    mapEstimate: int = 1
    cphdDistType: int = 0
    nu: float = 1.0
    labeledMeasurements: bool = False

    # Ackerman geometry (Victoria Park convention)
    l: float = 0.0
    h: float = 0.0
    a: float = 0.0
    b: float = 0.0
    stdAlpha: float = 0.0
    stdEncoder: float = 0.0

    # I/O
    saveAllMaps: bool = False
    savePrediction: bool = False
    dataDirectory: str = "data/"
    nSteps: int = -1

    # ---- rebuild-only knobs (no reference equivalent) ----
    # Padded feature-slot count per particle map. The reference never
    # enforces max_features (src/main.cpp:1003 is parsed but unused in
    # phdfilter.cu); we bound maps at maxFeatures via weight-ranked
    # truncation and use this padding for fixed shapes under jit.
    maxMeasurements: int = 64   # padded measurement slots (ref caps at 256)
    mergeCandidates: int = 0    # 0 -> auto: top-K pool for prune+merge
    mergeMode: int = 0          # 0 = exact greedy (reference semantics,
                                # default); 1 = fast: pre-merge prune at
                                # mergeMinWeight with mass renormalization
                                # (documented deviation, PARITY.md) — cuts
                                # the greedy trip count, the dense step's
                                # dominant cost
    mergeMinWeight: float = 1e-3  # fast-mode prune threshold (>= the
                                  # reference's minFeatureWeight)
    usePallas: bool = True      # run the hand-written kernels
                                # (kernels/) where kernels.kernel_mode
                                # allows: compiled on a GPU; on the CPU
                                # the XLA path runs instead
    pallasInterpret: bool = False  # run the kernel code path in Pallas
                                # interpret mode on the CPU (tests and the
                                # virtual-CPU-mesh dry run); slow, and an
                                # error on a GPU
    kernelPlatform: str = ""    # platform the kernels are compiled for;
                                # "" = the process default backend.
                                # parallel.mesh.resolve_pallas sets it
                                # from a mesh's devices
    selectTopK: int = 0         # detection candidates kept per
                                # measurement by the fused selection
                                # (the per-(p,m) top-k1). 0 = auto:
                                # 8 exact / 4 in merge_mode=1. Lower is
                                # faster (the pick loop is ~40% of the
                                # dense select kernel); accuracy evidence
                                # for 2 vs 4 in RESULTS.md
    birthVelocityInit: bool = False  # informed 4-D births (two-detection
                                # velocity initialization): seed a dynamic
                                # birth's velocity mean from the nearest
                                # previous-step measurement,
                                # (p_t - p_{t-1})/dt, with the honestly
                                # propagated variance 2*sigma_p^2/dt^2
                                # (capped at the covVxBirth prior);
                                # unmatched measurements keep the zero-mean
                                # covVxBirth prior. Rebuild extension —
                                # the reference births at zero velocity
                                # (src/phdfilter.cu:244-299).
    keepOobDynamic: bool = False  # pass out-of-FOV DYNAMIC features
                                # through the update like static ones.
                                # The reference deliberately kills them
                                # ('TODO: hack to kill of out-of-range
                                # dynamic features',
                                # src/phdfilter.cu:3715-3719), so every
                                # mover that leaves the FOV loses its
                                # track and must re-confirm from birth on
                                # re-entry. Default False = the
                                # reference's hack; True = passthrough
                                # (measured to raise multi-dwell mover
                                # tracking, scripts/mixed_evidence.py).
    birthVelMax: float = 5.0    # informed-birth association radius
                                # (birthVelMax * dt) and implied-speed cap
    birthWeightDynamic: float = -1.0  # birth weight for the DYNAMIC map in
                                # the mixed model; -1 (default) = use
                                # birthWeight for both maps, the
                                # reference's symmetric-birth semantics
                                # (src/phdfilter.cu:2501-2503, one
                                # birthWeight constant). Setting it higher
                                # than birthWeight lets a lone mover birth
                                # confirm against clutterDensity + the
                                # static doppelganger's detection split
                                # WITHOUT raising the static birth weight
                                # (which pollutes the static map/pose) —
                                # the round-4 confirmation-failure fix;
                                # evidence: results/mixed_dwell_oracle.json
                                # + RESULTS.md mixed section.
    minSeparationDynamic: float = -1.0  # merge threshold (squared
                                # Mahalanobis) for the DYNAMIC (4-D) map in
                                # the mixed model; -1 (default) = use
                                # minSeparation for both maps, the
                                # reference's symmetric semantics (one
                                # min_separation constant,
                                # src/phdfilter.cu:2707). The round-5
                                # snowball diagnosis (RESULTS.md mixed
                                # section) showed successive mover births
                                # merging under the averaged-covariance
                                # Mahalanobis at minSeparation = 5, with
                                # moment-matching inflating the merged
                                # covariance until one smeared feature
                                # swallows the whole birth trail; a
                                # smaller dynamic-only threshold keeps
                                # mover components sharp without touching
                                # the tuned static merge.
    fastslamAssoc: int = 1      # FastSLAM (filter_type = 2) association:
                                # 1 (default) = joint auction assignment
                                # (the working realization of the
                                # reference's munkres_assign intent,
                                # src/fastslam.cu:21-366); 0 = gated
                                # per-measurement ML with winner-takes-
                                # feature conflict resolution (classic
                                # FastSLAM 1.0).
    fastslamGate: float = 9.21  # chi-square(2 dof, 99%) Mahalanobis gate
                                # on measurement-feature association — the
                                # Q-matrix gate the reference's
                                # preupdate_kernel computes
                                # (src/fastslam.cu:395-399).
    cnPoissonPredict: bool = True  # CPHD predicted-cardinality prior:
                                # True (default) rebuilds it as Poisson of
                                # the full-map intensity mass each step —
                                # the reference's LIVE behavior (the host
                                # loop at phdfilter.cu.bak:2473-2497
                                # overwrites the cardinalityPredictKernel
                                # convolution before the update reads it).
                                # False propagates the posterior through
                                # the birth convolution instead (the
                                # kernel the reference computes but never
                                # uses).

    # ---- derived ----
    clutterDensity: float = dataclasses.field(default=0.0)

    def __post_init__(self):
        if self.clutterDensity == 0.0:
            object.__setattr__(
                self, "clutterDensity",
                self.clutterRate / (2.0 * self.maxBearing * self.maxRange))
        # The fused selection kernels unroll selectTopK picks; a negative
        # value would surface as an opaque trace-time shape error and >8
        # silently inflates the pick loop + merge-candidate section.
        if not (0 <= self.selectTopK <= 8):
            raise ValueError(
                f"select_top_k must be in [0, 8] (0 = auto), got "
                f"{self.selectTopK}")
        # FastSLAM (filter_type = 2) maintains per-particle EKF maps in the
        # static channel only; a mixed/dynamic feature model would be
        # silently ignored by fastslam_update rather than tracked.
        if self.filterType == 2 and self.featureModel != 0:
            raise ValueError(
                "filter_type = 2 (FastSLAM) supports only feature_model = 0 "
                f"(static landmarks), got feature_model = {self.featureModel}")

    def replace(self, **kw) -> "SlamConfig":
        if ("clutterRate" in kw or "maxBearing" in kw or "maxRange" in kw) \
                and "clutterDensity" not in kw:
            kw["clutterDensity"] = 0.0  # force re-derivation
        return dataclasses.replace(self, **kw)

    @property
    def merge_pool_size(self) -> int:
        """Size of the top-K candidate pool fed to the greedy merge."""
        if self.mergeCandidates > 0:
            return self.mergeCandidates
        return 2 * self.maxFeatures + self.maxMeasurements


# cfg-file key -> dataclass field, per the boost::program_options table
# (src/main.cpp:960-1049). Keys the reference parses into local globals
# (data_directory, n_steps) map to dataclass fields here.
_KEY_MAP = {
    "debug": "debug",
    "initial_x": "x0", "initial_y": "y0", "initial_z": "z0",
    "initial_roll": "roll0", "initial_pitch": "pitch0", "initial_yaw": "yaw0",
    "initial_vx": "vx0", "initial_vy": "vy0", "initial_vz": "vz0",
    "initial_vroll": "vroll0", "initial_vpitch": "vpitch0",
    "initial_vyaw": "vyaw0",
    # legacy aliases appearing in the shipped cfg header comments
    "initial_theta": "yaw0", "initial_vtheta": "vyaw0",
    "follow_trajectory": "followTrajectory",
    "motion_type": "motionType",
    "acc_x": "ax", "acc_y": "ay", "acc_z": "az",
    "acc_roll": "aroll", "acc_pitch": "apitch", "acc_yaw": "ayaw",
    "dt": "dt",
    "max_bearing": "maxBearing", "min_range": "minRange",
    "max_range": "maxRange",
    "std_bearing": "stdBearing", "std_range": "stdRange",
    "clutter_rate": "clutterRate", "pd": "pd", "ps": "ps",
    "n_particles": "n_particles",
    "n_predict_particles": "nPredictParticles",
    "resample_threshold": "resampleThresh",
    "subdivide_predict": "subdividePredict",
    "birth_weight": "birthWeight",
    "birth_noise_factor": "birthNoiseFactor",
    "gate_births": "gateBirths",
    "gate_measurements": "gateMeasurements",
    "gate_threshold": "gateThreshold",
    "feature_model": "featureModel",
    "min_expected_feature_weight": "minExpectedFeatureWeight",
    "min_separation": "minSeparation",
    "max_features": "maxFeatures",
    "min_feature_weight": "minFeatureWeight",
    "particle_weighting": "particleWeighting",
    "daughter_mixture_type": "daughterMixtureType",
    "n_samples": "nSamples",
    "max_cardinality": "maxCardinality",
    "cn_poisson_predict": "cnPoissonPredict",
    "select_top_k": "selectTopK",
    "filter_type": "filterType",
    "map_estimate": "mapEstimate",
    "cphd_disttype": "cphdDistType",
    "nu": "nu",
    "distance_metric": "distanceMetric",
    "h": "h", "l": "l", "a": "a", "b": "b",
    "std_encoder": "stdEncoder", "std_alpha": "stdAlpha",
    "std_vx_features": "stdVxMap", "std_vy_features": "stdVyMap",
    "std_ax_features": "stdAxMap", "std_ay_features": "stdAyMap",
    "cov_vx_birth": "covVxBirth", "cov_vy_birth": "covVyBirth",
    "std_u": "stdU", "std_v": "stdV",
    "disparity_birth": "disparityBirth",
    "image_width": "imageWidth", "image_height": "imageHeight",
    "std_d_birth": "stdDBirth",
    "fx": "fx", "fy": "fy", "u0": "u0", "v0": "v0",
    "particles_per_feature": "particlesPerFeature",
    "tau": "tau", "beta": "beta",
    "labeled_measurements": "labeledMeasurements",
    "data_directory": "dataDirectory",
    "max_time_steps": "maxSteps",
    "save_all_maps": "saveAllMaps",
    "save_prediction": "savePrediction",
    "n_steps": "nSteps",
    # rebuild extensions
    "max_measurements": "maxMeasurements",
    "merge_candidates": "mergeCandidates",
    "merge_mode": "mergeMode",
    "merge_min_weight": "mergeMinWeight",
    "use_pallas": "usePallas",
    "pallas_interpret": "pallasInterpret",
    "birth_velocity_init": "birthVelocityInit",
    "keep_oob_dynamic": "keepOobDynamic",
    "birth_vel_max": "birthVelMax",
    "birth_weight_dynamic": "birthWeightDynamic",
    "fastslam_assoc": "fastslamAssoc",
    "fastslam_gate": "fastslamGate",
    "min_separation_dynamic": "minSeparationDynamic",
}

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(SlamConfig)}


def _coerce(field: str, raw: str):
    ftype = _FIELD_TYPES[field]
    raw = raw.strip()
    if ftype in ("bool", bool):
        # boost::program_options accepts 0/1/true/false
        return raw.lower() in ("1", "true", "yes", "on")
    if ftype in ("int", int):
        return int(float(raw))
    if ftype in ("float", float):
        return float(raw)
    return raw


def parse_config_text(text: str) -> SlamConfig:
    """Parse the reference cfg dialect: ``key = value`` lines, ``#`` comments
    (including trailing comments), blank lines."""
    values = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, _, raw = line.partition("=")
        key = key.strip()
        field = _KEY_MAP.get(key)
        if field is None:
            continue  # tolerate unknown keys like boost's allow_unregistered
        values[field] = _coerce(field, raw)
    return SlamConfig(**values)


def load_config(path: str) -> SlamConfig:
    """Parse a cfg file. A relative data_directory resolves from the
    checkout root, so a run starts from any working directory."""
    import os

    from phdslam_tpu.utils import REPO_ROOT

    with open(path, "r") as f:
        cfg = parse_config_text(f.read())
    if not os.path.isabs(cfg.dataDirectory):
        cfg = cfg.replace(
            dataDirectory=os.path.join(REPO_ROOT, cfg.dataDirectory))
    return cfg
