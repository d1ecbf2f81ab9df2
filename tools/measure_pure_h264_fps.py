#!/usr/bin/env python
"""Pure-tier H.264 decode throughput on THIRD-PARTY (x264) streams.

VERDICT r3 ask #4: quantify what the zero-dep ingest tier sustains on
streams it did not encode itself.  Encodes monitor-op-point streams
(560x352, x264 CRF30/veryfast/zerolatency/gop1 — src/module/monitor.rs:21-22
semantics) via the libavcodec shim, then times each pure-tier decoder:

  native   — C++ full baseline-intra decoder (mixlab_native h264_decode_islice)
  python   — vectorized two-pass FastSliceDecoder (only where in-surface;
             full-intra x264 streams raise H264Unsupported -> scalar)
  scalar   — the per-MB Python oracle (_SliceDecoder)

Host-CPU measurement (the decode tier never touches the device).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def content(kind, w, h, n, seed=0, pan=False):
    rng = np.random.default_rng(seed)
    frames = []
    if pan:  # temporally coherent: a panning window over a fixed texture
        if kind == "gradient":
            base = (np.add.outer(np.arange(h * 2), np.arange(w * 2)) * 2
                    % 256).astype(np.uint8)
        else:
            base = rng.integers(0, 256, (h * 2, w * 2), dtype=np.uint8)
        cu = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cv = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for i in range(n):
            oy, ox = (3 * i) % h, (2 * i) % w
            frames.append((
                base[oy:oy + h, ox:ox + w].copy(),
                cu[oy // 2:oy // 2 + h // 2,
                   ox // 2:ox // 2 + w // 2].copy(),
                cv[oy // 2:oy // 2 + h // 2,
                   ox // 2:ox // 2 + w // 2].copy()))
        return frames
    for i in range(n):
        if kind == "gradient":
            y = (np.add.outer(np.arange(h), np.arange(w)) * (2 + i) % 256).astype(np.uint8)
            u = np.full((h // 2, w // 2), 90 + i, np.uint8)
            v = (np.add.outer(np.arange(h // 2), np.arange(w // 2)) * 3 % 256).astype(np.uint8)
        else:  # noise — max entropy, worst case for entropy decode
            y = rng.integers(0, 256, (h, w), dtype=np.uint8)
            u = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
            v = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
        frames.append((y, u, v))
    return frames


def encode(w, h, frames, opts):
    from mixlab_tpu.native import avshim

    enc = avshim.VideoEncoder(w, h, fps=30, opts=opts)
    for i, (y, u, v) in enumerate(frames):
        enc.send(y, u, v, i)
    enc.flush()
    pk = enc.receive()
    ed = enc.extradata()
    enc.close()
    return ed, pk


def time_tier(ed, pk, tier, max_frames=None):
    from mixlab_tpu.av.h264dec import PureH264Decoder

    env = {}
    if tier == "scalar":
        env["MIXLAB_PURE_H264_SCALAR"] = "1"
    elif tier == "python":
        # knock out the native tier so the Python fast path (and its typed
        # H264Unsupported fallback to scalar) is what runs
        env["MIXLAB_PURE_H264_PYFULL"] = "1"
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dec = PureH264Decoder()
        dec.decode_annexb(ed)
        todo = pk[:max_frames] if max_frames else pk
        t0 = time.perf_counter()
        n = 0
        for _pts, _dts, _key, data in todo:
            n += len(dec.decode_annexb(data))
        dt = time.perf_counter() - t0
        return n / dt
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main():
    from mixlab_tpu.native import avshim

    if not avshim.available():
        print("shim unavailable; cannot generate x264 streams")
        return 1
    w, h = 560, 352
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    profiles = (
        # (label, x264 opts, tiers to time) — main = CABAC entropy (round 5);
        # the Python CABAC tier is the scalar entropy decoder, no fast path.
        ("baseline", "preset=veryfast,profile=baseline,tune=zerolatency,"
                     "g=1,crf=30,threads=1",
         (("native", None), ("python", 6), ("scalar", 3))),
        ("cabac", "preset=veryfast,profile=main,tune=zerolatency,"
                  "g=1,crf=30,threads=1",
         (("native", None), ("scalar", 3))),
        # inter streams (round 5): what real RTMP publishers send — the
        # default x264 broadcast shape (CABAC, P slices, gop 250) plus the
        # CAVLC-inter variant
        ("inter-cavlc", "preset=veryfast,profile=baseline,"
                        "tune=zerolatency,g=250,crf=30,threads=1",
         (("native", None), ("scalar", 3))),
        ("inter-cabac", "preset=veryfast,profile=main,tune=zerolatency,"
                        "g=250,crf=30,threads=1",
         (("native", None), ("scalar", 3))),
    )
    for prof, opts, tiers in profiles:
        for kind in ("gradient", "noise"):
            frames = content(kind, w, h, n_frames,
                             pan="inter" in prof)
            ed, pk = encode(w, h, frames, opts)
            kbps = sum(len(d) for *_x, d in pk) * 8 * 30 / n_frames / 1000
            line = f"{prof:11s} {kind:9s} ({kbps:7.0f} kb/s)"
            for tier, cap in tiers:
                fps = time_tier(ed, pk, tier, max_frames=cap)
                line += f"  {tier}: {fps:7.1f} fps"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
