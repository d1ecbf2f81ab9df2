#!/usr/bin/env python
"""Knock-out profile of config5's VIDEO pipeline (the stage costs behind
the ~1.2k x full-session number).

Each variant slope-times 30-frame batches of progressively fewer stages;
successive differences attribute cost per stage per frame.  Run on the
real chip: python tools/profile_config5.py [reps]
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

    from mixlab_tpu.video.blend import crossfade_xla
    from mixlab_tpu.video.colorspace import rgb_to_yuv420
    from mixlab_tpu.video.pattern import gradient_rgb
    from mixlab_tpu.video.scale import resize_plane

    FRAMES = 30

    def stage_pattern(i):
        rgb = gradient_rgb(960, 540, t=i)
        return (jnp.sum(rgb.astype(jnp.uint32)),)

    def stage_yuv(i):
        rgb = gradient_rgb(960, 540, t=i)
        y, u, v = rgb_to_yuv420(rgb)
        return y, u, v

    def stage_resize(i):
        y, u, v = stage_yuv(i)
        return (
            resize_plane(y, 1080, 1920),
            resize_plane(u, 540, 960),
            resize_plane(v, 540, 960),
        )

    def stage_full(i):
        y1, u, v = stage_resize(i)
        y2 = crossfade_xla(y1, jnp.roll(y1, 1, axis=0), 128)
        return y2, u, v

    def stage_xfade_only(i):
        # crossfade WITHOUT resize: isolates the blend at 1080p using a
        # broadcast-from-540p y (upsample by repeat, not matmul)
        y, u, v = stage_yuv(i)
        y1 = jnp.repeat(jnp.repeat(y, 2, axis=0), 2, axis=1)
        y2 = crossfade_xla(y1, jnp.roll(y1, 1, axis=0), 128)
        return y2, u, v

    def stage_full_fused(i):
        # the algebraically folded path (video/fused.py): roll+crossfade
        # pre-blended into the row-resize matrix
        from mixlab_tpu.video.fused import resize_crossfade_roll

        y, u, v = stage_yuv(i)
        y2 = resize_crossfade_roll(y, 1080, 1920, 128)
        return y2, resize_plane(u, 540, 960), resize_plane(v, 540, 960)

    def bench(stage, reps):
        def make(n):
            def whole(_):
                def step(carry, k):
                    ts = k * FRAMES + jnp.arange(FRAMES, dtype=jnp.int32)
                    outs = jax.vmap(stage)(ts)
                    s = sum(jnp.sum(o.astype(jnp.uint32)) for o in outs)
                    return carry + s, None

                total, _ = jax.lax.scan(
                    step, jnp.uint32(0), jnp.arange(n, dtype=jnp.int32)
                )
                return total

            f = jax.jit(whole)
            return lambda: f(0)

        # n = content-seconds of 1080p30
        return timed_slope(make, 2, 10, reps=reps)

    def cost(stage):
        """XLA's own cost analysis (flops / bytes accessed) for one
        30-frame batch of the stage pipeline — the VERDICT r3 ask: show
        where config5's time goes in the compiler's accounting, not just
        wall deltas."""
        ts = jnp.arange(FRAMES, dtype=jnp.int32)

        def batch(ts):
            outs = jax.vmap(stage)(ts)
            return sum(jnp.sum(o.astype(jnp.uint32)) for o in outs)

        ca = jax.jit(batch).lower(ts).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        return (
            float(ca.get("flops", 0.0)) / FRAMES,
            float(ca.get("bytes accessed", 0.0)) / FRAMES,
        )

    from bench import PEAKS

    peaks = PEAKS[jax.devices()[0].device_kind]  # KeyError: kind unlisted
    PEAK_FLOPS, PEAK_HBM = peaks["bf16_flops"], peaks["hbm_bytes_s"]

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    stages = [
        ("pattern", stage_pattern),
        ("+rgb2yuv", stage_yuv),
        ("+resize", stage_resize),
        ("+xfade(full)", stage_full),
        ("FUSED full", stage_full_fused),
        ("xfade-no-resize", stage_xfade_only),
    ]
    results, costs = {}, {}
    for name, fn in stages:
        s = bench(fn, reps)
        fl, by = cost(fn)
        results[name], costs[name] = s, (fl, by)
        print(
            f"{name:18s} {1e6 * s:9.1f} us/content-s  "
            f"({1e6 * s / FRAMES:7.2f} us/frame, {1.0/s:7.0f} x)  "
            f"[{fl/1e6:8.1f} Mflop {by/1e6:7.2f} MB accessed /frame]",
            flush=True,
        )
    print("\nper-stage attribution (per frame):")
    print(f"  {'stage':14s} {'Δus':>8s} {'ΔMflop':>9s} {'ΔMB':>8s} "
          f"{'roofline us':>12s} {'bound':>6s}")
    order = ["pattern", "+rgb2yuv", "+resize", "+xfade(full)"]
    pt, pf, pb = 0.0, 0.0, 0.0
    for name in order:
        cur = 1e6 * results[name] / FRAMES
        fl, by = costs[name]
        dt, df, db = cur - pt, fl - pf, by - pb
        roof_f, roof_b = df / PEAK_FLOPS * 1e6, db / PEAK_HBM * 1e6
        bound = "flops" if roof_f > roof_b else "HBM"
        print(f"  {name:14s} {dt:8.2f} {df/1e6:9.1f} {db/1e6:8.2f} "
              f"{max(roof_f, roof_b):12.2f} {bound:>6s}")
        pt, pf, pb = cur, fl, by

    sf, sb = costs["+xfade(full)"]
    ff, fb = costs["FUSED full"]
    print(f"\nseparate vs fused whole pipeline (per frame): "
          f"flops {sf/1e6:.1f} -> {ff/1e6:.1f} Mflop, "
          f"bytes {sb/1e6:.2f} -> {fb/1e6:.2f} MB, "
          f"time {1e6*results['+xfade(full)']/FRAMES:.2f} -> "
          f"{1e6*results['FUSED full']/FRAMES:.2f} us")


if __name__ == "__main__":
    main()
