"""On-device latency + accuracy probe for the in-loop OSPA (ospa_jax).

Times the jitted auction-based OSPA on the default device at set sizes up
to the reference's measurement cap (M=256, src/phdfilter.cu:120), and
records the worst metric gap vs the exact JV solution (ospa_np). Writes
results/ospa_latency.json, rendered into RESULTS.md by eval_baselines.py.

    python scripts/ospa_latency.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phdslam_tpu.ops.ospa import ospa_jax, ospa_np  # noqa: E402
from phdslam_tpu.utils import configure_compile_cache  # noqa: E402


def probe(n_pad: int, n_seeds: int = 8, n_time: int = 20):
    gaps = []
    lat_ms = None
    for seed in range(n_seeds):
        r = np.random.default_rng(seed)
        m_x = int(r.integers(n_pad // 2, n_pad + 1))
        m_y = int(r.integers(n_pad // 2, n_pad + 1))
        x = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
        y = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
        xv = np.arange(n_pad) < m_x
        yv = np.arange(n_pad) < m_y
        args = (jnp.asarray(x), jnp.asarray(xv), jnp.asarray(y),
                jnp.asarray(yv))
        je, jl, jc = ospa_jax(*args, p=1.0, c=5.0)
        ne, nl, nc = ospa_np(x[:m_x], y[:m_y], p=1, c=5)
        gaps.append(abs(float(je) - ne))
        if seed == 0:
            # timed window on the worst-case-shaped first draw
            jax.block_until_ready(je)  # warm/compile
            t0 = time.time()
            for _ in range(n_time):
                e, _, _ = ospa_jax(*args, p=1.0, c=5.0)
            jax.block_until_ready(e)
            lat_ms = (time.time() - t0) * 1e3 / n_time
    return dict(n=n_pad, ms=round(lat_ms, 3), max_gap=round(max(gaps), 5),
                seeds=n_seeds)


def main():
    configure_compile_cache()
    print("device:", jax.devices()[0].device_kind)
    rows = [probe(n) for n in (16, 64, 256)]
    for r in rows:
        print(r)
    out = dict(device=jax.devices()[0].device_kind, rows=rows,
               note="jit ospa_jax latency (mean of 20 back-to-back calls, "
                    "to block_until_ready) and worst |ospa_jax - ospa_np| "
                    "over 8 random set pairs, p=1 c=5")
    os.makedirs("results", exist_ok=True)
    with open("results/ospa_latency.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
