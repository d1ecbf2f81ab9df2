"""Per-stage profile of the ZERO-DEP publish pipeline at the reference
broadcast op point (1120x700, stream_output.rs:23-24).

VERDICT r4 weak #3: the pure tier published at 15 fps while the standalone
C++ encoder measures ~49 fps — where do the other frames go?  This tool
times each stage of the real pipeline separately on host CPU:

  * source: synthetic 720p frames (what a video_mixer tap hands over)
  * scale:   bicubic to 1120x700 (video/scale.py, jax host/device)
  * h264:    PureH264Stream.feed + poll (C++ CAVLC intra twin)
  * aac:     rate-controlled AAC-LC at 160k (av/aacenc.py)
  * flv+rtmp: tag wrap + loopback socket send

Usage: JAX_PLATFORMS=cpu python tools/profile_pure_publish.py [seconds]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 3.0
    from mixlab_tpu.av import flv
    from mixlab_tpu.av.aacenc import AacLcEncoder
    from mixlab_tpu.av.codecs import STREAM_PICTURE
    from mixlab_tpu.av.h264enc import PureH264Stream
    from mixlab_tpu.av.encode_stream import f32_to_i16
    from mixlab_tpu.video.frame import Picture, PictureSettings
    from mixlab_tpu.video.scale import scale_picture

    rng = np.random.default_rng(0)
    h, w = 720, 1280
    yy, xx = np.mgrid[0:h, 0:w]

    def frame(i):
        y = ((xx * 255 // (w - 1) + i * 3) % 256).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + (i % 40), np.uint8)
        v = np.full((h // 2, w // 2), 160 - (i % 40), np.uint8)
        return Picture(PictureSettings(w, h), {"y": y, "u": u, "v": v})

    n_frames = max(int(seconds * 30), 30)
    frames = [frame(i) for i in range(8)]

    # stage 1a: the dense-matmul scaler forced through host jax (what
    # the pure tier used before round 5 — the measured limiter)
    t0 = time.perf_counter()
    for i in range(min(n_frames, 15)):
        pic = scale_picture(frames[i % 8], STREAM_PICTURE)
        Picture(pic.settings,
                {k: np.asarray(v) for k, v in pic.planes.items()})
    t_scale_jax = (time.perf_counter() - t0) * n_frames / min(n_frames, 15)

    # stage 1b: the banded host twin (what the pure tier uses now)
    from mixlab_tpu.video.scale_host import scale_picture_host

    t0 = time.perf_counter()
    scaled = []
    for i in range(n_frames):
        scaled.append(scale_picture_host(frames[i % 8], STREAM_PICTURE))
    t_scale = time.perf_counter() - t0

    # stage 2: H.264 encode (C++ twin through the stream wrapper)
    enc = PureH264Stream(STREAM_PICTURE, fps=30, profile="stream", qp=32)
    t0 = time.perf_counter()
    nbytes = 0
    for i in range(n_frames):
        enc.feed(scaled[i])
        for _k, au in enc.poll_access_units():
            nbytes += len(au)
    t_h264 = time.perf_counter() - t0

    # stage 3: AAC at the op point (same wall-span of audio as the video)
    aac = AacLcEncoder(44100, 2, bitrate=160_000)
    audio_s = n_frames / 30.0
    tpcm = np.arange(int(44100 * audio_s)) / 44100
    sig = np.stack([0.4 * np.sin(2 * np.pi * 440 * tpcm),
                    0.4 * np.sin(2 * np.pi * 554 * tpcm)], axis=1)
    pcm16 = f32_to_i16(sig.reshape(-1)).reshape(-1, 2)
    t0 = time.perf_counter()
    abytes = 0
    for g in range(len(pcm16) // 1024):
        abytes += len(aac.encode_granule(pcm16[g * 1024:(g + 1) * 1024]))
    t_aac = time.perf_counter() - t0

    # stage 4: FLV wrap + loopback TCP send of the video payloads
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.socket()
    cli.connect(srv.getsockname())
    conn, _ = srv.accept()
    payload = bytes(nbytes // max(n_frames, 1))
    t0 = time.perf_counter()
    for i in range(n_frames):
        body = flv.VideoPacket(flv.VideoFrameType.KEY_FRAME,
                               flv.VideoPacketType.NALU, 0, payload).to_bytes()
        cli.sendall(body)
        while len(body) > 0:
            got = conn.recv(65536)
            body = body[len(got):]
    t_flv = time.perf_counter() - t0
    cli.close(); conn.close(); srv.close()

    span = n_frames / 30.0
    print(f"frames: {n_frames} (= {span:.1f} s of 30 fps video), "
          f"video {nbytes/span/125_000:.1f} kb/s, audio {abytes*8/audio_s/1000:.0f} kb/s")
    for name, t in (("scale (jax dense, old)", t_scale_jax),
                    ("scale (banded host)", t_scale), ("h264 encode", t_h264),
                    ("aac 160k", t_aac), ("flv+tcp", t_flv)):
        print(f"  {name:22s} {t:6.2f} s  ({n_frames/t:6.1f} fps-equiv, "
              f"{t/span*100:5.1f}% of realtime)")
    total = t_scale + t_h264 + t_aac + t_flv
    print(f"  {'TOTAL (shipping path)':22s} {total:6.2f} s  "
          f"({n_frames/total:6.1f} fps-equiv, {total/span*100:5.1f}% of realtime)")


if __name__ == "__main__":
    main()
