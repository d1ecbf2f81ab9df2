#!/usr/bin/env python
"""Interleaved A/B: dense vs block-banded int8 resize matmuls on chip.

The dense s8 resize matrix is 99% zeros.  The banded
path (video/scale.py _banded_blocks_i8) keeps matmuls but contracts each
output block only against its input window — 3.4x fewer MACs at config5's
2x upscale — and is bit-identical by construction.  This measures whether
fewer MACs translate to wall time at config5's geometry.

Interleaved pairs in ONE process (contention-robust); slope-timed.
Run on the real chip: python tools/ab_banded_resize.py [pairs]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bench import timed_slope  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from mixlab_tpu.video import scale

    FRAMES = 30
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    def resize_stage(i):
        # carry-dependent synthetic planes (defeat loop-invariant hoisting)
        row = (i + jnp.arange(960, dtype=jnp.int32)) % 256
        y = (row[None, :] + jnp.arange(540, dtype=jnp.int32)[:, None]
             ).astype(jnp.uint8)
        u = y[::1, :480][:270]
        v = y[:270, :480]
        return (
            scale.resize_plane(y, 1080, 1920),
            scale.resize_plane(u, 540, 960),
            scale.resize_plane(v, 540, 960),
        )

    def bench(reps):
        def make(n):
            def whole(_):
                def step(carry, k):
                    ts = k * FRAMES + jnp.arange(FRAMES, dtype=jnp.int32)
                    outs = jax.vmap(resize_stage)(ts)
                    s = sum(jnp.sum(o.astype(jnp.uint32)) for o in outs)
                    return carry + s, None

                total, _ = jax.lax.scan(
                    step, jnp.uint32(0), jnp.arange(n, dtype=jnp.int32))
                return total

            f = jax.jit(whole)
            return lambda: f(0)

        return timed_slope(make, 4, 8, reps=reps)

    results = {"dense": [], "banded": []}
    for p in range(pairs):
        for name, flag in (("dense", "0"), ("banded", "1")):
            os.environ["MIXLAB_RESIZE_BANDED"] = flag
            scale._banded_blocks_i8.cache_clear()
            sec = bench(reps=1)
            us_frame = sec * 1e6 / FRAMES
            results[name].append(us_frame)
            print(f"pair {p} {name:6s}: {us_frame:8.2f} us/frame", flush=True)

    for name, vals in results.items():
        print(f"{name:6s}: median {np.median(vals):8.2f} us/frame "
              f"(min {min(vals):.2f}, max {max(vals):.2f}, n={len(vals)})")


if __name__ == "__main__":
    main()
