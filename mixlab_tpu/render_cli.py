"""Offline render CLI.

``python -m mixlab_tpu.render_cli project.mixlab out.wav --seconds 10``

Loads the workspace from a project file and renders the first Monitor
module offline.  The output format follows the extension:

  * ``.wav``  — scanned (single-dispatch) device render to PCM.
  * ``.flac`` — same render, written losslessly via the pure FLAC
    encoder (av/flacenc.py).
  * ``.mp4``  — full A/V export: the engine ticks unthrottled in
    direct-drive mode with back-pressure against the monitor codec
    thread (no drop-on-lag), and the fMP4 stream (same tiers as the
    live monitor: AAC+H.264 via the shim, FLAC+CAVLC pure) is written
    as a playable file.  Media sources in the project play into the
    export.

A capability the reference lacks entirely — it can only run in realtime.
"""

from __future__ import annotations

import argparse

import numpy as np


def _render_mp4(project_path: str, cfg, n_ticks: int, out_path: str):
    """A/V export: direct-drive engine + monitor pipeline, back-pressured
    against the codec thread so no tick is dropped."""
    import queue
    import time

    from mixlab_tpu.engine.project import open_or_create

    proj = open_or_create(project_path, cfg)
    try:
        eng = proj.engine
        monitors = [mid for mid, e in eng.ws.modules.items()
                    if e.params.kind == "Monitor"]
        if not monitors:
            raise SystemExit("no Monitor module in the patch")
        mon = monitors[0]
        pipe = eng.monitor_pipe(mon)
        pipeline = eng._monitor_pipelines[mon]
        sub = pipeline.broadcast.subscribe()
        segments = []
        # MediaPlayer decode threads are wall-clock paced (MediaThrottle),
        # so a project with media sources must export at realtime; pure
        # synthesis projects tick as fast as the codec allows
        has_media = any(e.params.kind == "MediaSource"
                        for e in eng.ws.modules.values())
        if has_media:
            print("project has media sources: exporting at realtime pace")
        t_start = time.monotonic()
        tick_period = 1.0 / cfg.ticks_per_second

        def drain():
            while True:
                try:
                    pkt = sub.get_nowait()
                except queue.Empty:
                    return
                header, _, body = pkt.partition(b"\n")
                if b'"segment"' in header:
                    segments.append(body)

        for i in range(n_ticks):
            # offline back-pressure: never outrun the codec queue (the
            # live path drops on lag instead — monitor.rs:164-176); a dead
            # codec thread must fail the export, not hang it
            bp_deadline = time.monotonic() + 30.0
            while not pipe.q.empty():
                if not pipeline.is_alive():
                    raise SystemExit("monitor codec thread died mid-export")
                if time.monotonic() > bp_deadline:
                    raise SystemExit("monitor codec stalled >30 s")
                time.sleep(0.001)
            if has_media:
                target = t_start + i * tick_period
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            eng.tick_once()
            drain()
        deadline = time.time() + 10.0
        while not pipe.q.empty() and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # let the codec thread finish the tail
        pipeline.stop()
        pipeline.join(timeout=5)
        drain()
        init = pipeline.broadcast.init_packet
        header = init.partition(b"\n")[0].decode()
        if '"fmp4"' not in header:
            raise SystemExit(f"monitor is not in fmp4 mode: {header}")
        with open(out_path, "wb") as f:
            f.write(init.partition(b"\n")[2])
            for seg in segments:
                f.write(seg)
        print(f"wrote {out_path}: {len(segments)} segments, "
              f"mime {header.split('mime')[-1][3:90]}")
    finally:
        proj.engine.stop()
        proj.close()


def main():
    parser = argparse.ArgumentParser(prog="mixlab_tpu.render_cli")
    parser.add_argument("project", help="project file (.mixlab)")
    parser.add_argument("output", help="output path (.wav / .flac / .mp4)")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--sample-rate", type=int, default=None,
                        help="override engine sample rate")
    parser.add_argument("--block-ticks", type=int, default=60)
    args = parser.parse_args()

    from mixlab_tpu.utils.platform import apply_env_platform, enable_compile_cache

    apply_env_platform()
    enable_compile_cache()

    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.engine.graph import Workspace
    from mixlab_tpu.engine.project import ProjectBase
    from mixlab_tpu.engine.scan_render import render_scanned
    from mixlab_tpu.io_host.wav import write_wav

    if args.output.lower().endswith(".mp4"):
        cfg = EngineConfig(sample_rate=args.sample_rate or 44_100)
        n_ticks = max(int(args.seconds * cfg.ticks_per_second), 1)
        _render_mp4(args.project, cfg, n_ticks, args.output)
        return

    base = ProjectBase(args.project)
    saved = base.read_workspace()
    if saved is None:
        raise SystemExit("project has no workspace")
    ws = Workspace.from_persist(saved)

    monitors = [
        mid for mid, e in ws.modules.items() if e.params.kind == "Monitor"
    ]
    if not monitors:
        raise SystemExit("no Monitor module in the patch")
    mon = monitors[0]

    cfg = EngineConfig(sample_rate=args.sample_rate or 44_100)
    tps = cfg.ticks_per_second
    n_ticks = int(args.seconds * tps)
    n_ticks -= n_ticks % args.block_ticks
    if n_ticks == 0:
        n_ticks = args.block_ticks

    print(f"rendering {n_ticks} ticks ({n_ticks / tps:.1f}s) at {cfg.sample_rate} Hz ...")
    patch, (state, taps) = render_scanned(
        ws, n_ticks, cfg, block_ticks=args.block_ticks
    )
    from mixlab_tpu.dsp.base import interleave_tap

    audio = interleave_tap(taps[str(mon.value)]["audio"]).reshape(-1, 2)
    if args.output.lower().endswith(".flac"):
        from mixlab_tpu.av.flacenc import PureFlacStream
        from mixlab_tpu.native import pcm_f32_to_i16

        st = PureFlacStream(cfg.sample_rate, 2, block_size=4096)
        st.feed(pcm_f32_to_i16(np.asarray(audio)))
        with open(args.output, "wb") as f:
            f.write(st._enc.stream_header())
            for frame in st.poll_frames():
                f.write(frame)
            if len(st._buf):  # final partial block (spec-legal short last)
                f.write(st._enc.encode_frame(st._buf))
    else:
        write_wav(args.output, cfg.sample_rate, audio)
    peak = float(np.abs(audio).max())
    print(f"wrote {args.output}: {audio.shape[0]} frames, peak {peak:.3f}")


if __name__ == "__main__":
    main()
