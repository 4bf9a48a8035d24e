"""The SLAM state as one fixed-shape pytree.

Replaces the reference's ``SynthSLAM`` (vector<vector<Gaussian2D>> per
particle plus host-side offset bookkeeping, src/slamtypes.h:288-337 and
src/phdfilter.cu:2901-3103) with padded arrays + weight masks:

 - a map slot is *empty* iff its weight is exactly 0.0 — the linear-space
   analog of the reference's LOG0 convention; prune = zero the weight;
   compaction = weight-ranked top-k instead of thrust::remove_copy_if.
 - all shapes are static, so one jit of ``step`` serves every time step and
   the particle axis P shards cleanly over a device mesh.

Pose layout follows ConstantVelocityState (src/slamtypes.h:44-51):
``[px, py, ptheta, vx, vy, vtheta]``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from phdslam_tpu.utils import pytree_dataclass


@pytree_dataclass
class GaussianMixture:
    """Padded Gaussian mixture (array-of-structs): weights 0 = empty slots.

    w    [..., F]        linear-space weights (reference keeps map weights
                         linear too; log-space appears only transiently in
                         the pre-update, src/phdfilter.cu:384-388)
    mean [..., F, d]
    cov  [..., F, d, d]

    Used for the 4-D dynamic map (small) and host-side tooling. The hot 2-D
    static map uses the channelized ``Gaussian2DMixture`` below.
    """

    w: jax.Array
    mean: jax.Array
    cov: jax.Array

    @property
    def max_features(self) -> int:
        return self.w.shape[-1]

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def valid(self) -> jax.Array:
        return self.w > 0

    @property
    def cardinality(self) -> jax.Array:
        """Expected number of targets = sum of weights."""
        return jnp.sum(self.w, axis=-1)

    @classmethod
    def empty(cls, batch_shape, max_features: int, dim: int,
              dtype=jnp.float32) -> "GaussianMixture":
        bs = tuple(batch_shape)
        return cls(
            w=jnp.zeros(bs + (max_features,), dtype),
            mean=jnp.zeros(bs + (max_features, dim), dtype),
            cov=jnp.broadcast_to(
                jnp.eye(dim, dtype=dtype),
                bs + (max_features, dim, dim)).copy(),
        )


@pytree_dataclass
class Gaussian2DMixture:
    """Channelized (structure-of-arrays) padded 2-D Gaussian mixture.

    Every field is a [..., F] scalar array: weight, mean (mx, my), and the
    symmetric covariance (c00, c01, c11). Array-of-structs layouts like
    [P, F, 2, 2] put the tiny matrix dims innermost; scalar channels keep
    every elementwise Kalman/merge expression a contiguous [P, F] pass.
    This mirrors how the reference's Maple-expanded scalar kernels treat
    the 2x2 blocks (src/phdfilter.cu:332-364).
    """

    w: jax.Array
    mx: jax.Array
    my: jax.Array
    c00: jax.Array
    c01: jax.Array
    c11: jax.Array

    @property
    def max_features(self) -> int:
        return self.w.shape[-1]

    @property
    def valid(self) -> jax.Array:
        return self.w > 0

    @property
    def cardinality(self) -> jax.Array:
        return jnp.sum(self.w, axis=-1)

    # --- assembly views (host/tooling; avoid inside hot jit code) ---
    @property
    def mean(self) -> jax.Array:
        return jnp.stack([self.mx, self.my], axis=-1)

    @property
    def cov(self) -> jax.Array:
        return jnp.stack(
            [jnp.stack([self.c00, self.c01], axis=-1),
             jnp.stack([self.c01, self.c11], axis=-1)], axis=-2)

    @classmethod
    def empty(cls, batch_shape, max_features: int,
              dtype=jnp.float32) -> "Gaussian2DMixture":
        bs = tuple(batch_shape)
        z = jnp.zeros(bs + (max_features,), dtype)
        one = jnp.ones(bs + (max_features,), dtype)
        return cls(w=z, mx=z, my=z, c00=one, c01=z, c11=one)

    @classmethod
    def from_arrays(cls, w, mean, cov) -> "Gaussian2DMixture":
        return cls(w=jnp.asarray(w),
                   mx=jnp.asarray(mean[..., 0]),
                   my=jnp.asarray(mean[..., 1]),
                   c00=jnp.asarray(cov[..., 0, 0]),
                   c01=jnp.asarray(0.5 * (cov[..., 0, 1] + cov[..., 1, 0])),
                   c11=jnp.asarray(cov[..., 1, 1]))


@pytree_dataclass
class Gaussian4DMixture:
    """Channelized padded 4-D Gaussian mixture (dynamic features,
    [x, y, vx, vy]).

    w [..., F]; mean_channels [..., 4, F]; cov_channels [..., 10, F] with
    the symmetric 4x4 packed in row-major upper-triangle order (see
    update4.S4). The channel axis sits at -2 so the particle axis stays the
    leading axis (uniform tree ops) while the big F axis stays
    innermost.
    """

    w: jax.Array
    mean_channels: jax.Array
    cov_channels: jax.Array

    @property
    def max_features(self) -> int:
        return self.w.shape[-1]

    @property
    def valid(self) -> jax.Array:
        return self.w > 0

    @property
    def cardinality(self) -> jax.Array:
        return jnp.sum(self.w, axis=-1)

    # --- assembly views (host/tooling) ---
    @property
    def mean(self) -> jax.Array:
        return jnp.moveaxis(self.mean_channels, -2, -1)     # [..., F, 4]

    @property
    def cov(self) -> jax.Array:
        c = self.cov_channels
        idx = {}
        k = 0
        for i in range(4):
            for j in range(i, 4):
                idx[(i, j)] = k
                k += 1
        rows = []
        for i in range(4):
            rows.append(jnp.stack(
                [c[..., idx[(min(i, j), max(i, j))], :] for j in range(4)],
                axis=-1))
        return jnp.moveaxis(jnp.stack(rows, axis=-3), -3, -2)

    @classmethod
    def empty(cls, batch_shape, max_features: int,
              dtype=jnp.float32) -> "Gaussian4DMixture":
        bs = tuple(batch_shape)
        z = jnp.zeros(bs + (max_features,), dtype)
        diag = [0, 4, 7, 9]
        cov = jnp.stack([jnp.ones(bs + (max_features,), dtype)
                         if k in diag else z for k in range(10)], axis=-2)
        return cls(w=z,
                   mean_channels=jnp.zeros(bs + (4, max_features), dtype),
                   cov_channels=cov)

    @classmethod
    def from_arrays(cls, w, mean, cov) -> "Gaussian4DMixture":
        mean = jnp.asarray(mean)
        cov = jnp.asarray(cov)
        ch = []
        for i in range(4):
            for j in range(i, 4):
                ch.append(0.5 * (cov[..., i, j] + cov[..., j, i]))
        return cls(w=jnp.asarray(w),
                   mean_channels=jnp.moveaxis(mean, -1, -2),
                   cov_channels=jnp.stack(ch, axis=-2))


@pytree_dataclass
class SlamState:
    """Full Rao-Blackwellized particle filter state (one pytree).

    Mirrors SynthSLAM (src/slamtypes.h:288-311): per-particle pose, log
    weight, static (2-D) and dynamic (4-D) GM maps, CPHD cardinality
    distribution, MC variance estimate, and the resample indices of the last
    resampling (for the log format, src/main.cpp:937-942).
    """

    pose: jax.Array            # [P, 6]
    log_weights: jax.Array     # [P], log-space, normalized after update
    map_static: Gaussian2DMixture  # [P, F] channels
    map_dynamic: Gaussian4DMixture  # [P, Fd] channels
    resample_idx: jax.Array    # [P] int32
    variances: jax.Array       # [P]
    cardinality: Optional[jax.Array] = None  # [P, Nmax+1] log-pmf (CPHD)
    cn_birth: Optional[jax.Array] = None     # [P, Nmax+1] log-pmf (CPHD)

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]

    @classmethod
    def create(cls, config, dtype=jnp.float32) -> "SlamState":
        """Initial state per src/main.cpp:1130-1145: all particles at the
        configured initial pose, uniform weights -log(N)."""
        n = config.n_particles
        pose0 = jnp.array(
            [config.x0, config.y0, config.yaw0,
             config.vx0, config.vy0, config.vyaw0], dtype)
        pose = jnp.broadcast_to(pose0, (n, 6)).copy()
        f_static = config.maxFeatures
        f_dynamic = config.maxFeatures if config.featureModel != 0 else 0
        cardinality = None
        cn_birth = None
        if config.filterType == 1:  # CPHD
            nc = config.maxCardinality + 1
            cardinality = jnp.full((n, nc), -jnp.log(float(nc)), dtype)
            # initial birth cardinality: delta at 0 (src/main.cpp:1149-1151)
            cn_birth = jnp.full((n, nc), -3.4028235e38, dtype)
            cn_birth = cn_birth.at[:, 0].set(0.0)
        return cls(
            pose=pose,
            log_weights=jnp.full((n,), -jnp.log(float(n)), dtype),
            map_static=Gaussian2DMixture.empty((n,), f_static, dtype),
            map_dynamic=Gaussian4DMixture.empty((n,), f_dynamic, dtype),
            resample_idx=jnp.arange(n, dtype=jnp.int32),
            variances=jnp.zeros((n,), dtype),
            cardinality=cardinality,
            cn_birth=cn_birth,
        )


@pytree_dataclass
class Measurements:
    """Fixed-size padded measurement batch for one time step.

    The reference packs <=256 measurements into __constant__ memory
    (src/phdfilter.cu:120, :3389-3400); here a [M,2] array + validity mask
    + int labels, padded to config.maxMeasurements.
    """

    rb: jax.Array      # [M, 2] (range, bearing)
    label: jax.Array   # [M] int32 (STATIC/DYNAMIC measurement label)
    valid: jax.Array   # [M] bool

    @property
    def max_measurements(self) -> int:
        return self.rb.shape[0]

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))

    @classmethod
    def pad(cls, ranges, bearings, labels=None, max_measurements: int = 64,
            dtype=jnp.float32) -> "Measurements":
        import numpy as np
        m = min(len(ranges), max_measurements)
        rb = np.zeros((max_measurements, 2), dtype=np.float32)
        rb[:m, 0] = np.asarray(ranges)[:m]
        rb[:m, 1] = np.asarray(bearings)[:m]
        lab = np.zeros((max_measurements,), dtype=np.int32)
        if labels is not None:
            lab[:m] = np.asarray(labels)[:m]
        valid = np.zeros((max_measurements,), dtype=bool)
        valid[:m] = True
        return cls(rb=jnp.asarray(rb, dtype), label=jnp.asarray(lab),
                   valid=jnp.asarray(valid))
