"""Monitor sockets + codec pipeline.

Rebuild of ``src/module/monitor.rs``: each Monitor module gets a UUID socket
registered in a global map (monitor.rs:24-26); a codec thread consumes
(timestamp, audio, video) ticks from the engine over a bounded queue with
drop-on-lag (monitor.rs:154-176) and broadcasts encoded segments to every
WebSocket subscribed at ``/_monitor/<uuid>`` (monitor.rs:33-66).

Codec mode (av/codecs.py codec_tier selects the backend):
  * ``fmp4``    — audio + AVC into the fMP4 mux for MSE (reference parity).
                  Backends: libavcodec shim > ffmpeg CLI > pure zero-dep
                  (CAVLC intra H.264 + FLAC) — always capable;
  * ``pcm+png`` — preview mode: s16le audio ticks + PNG video frames at
                  ~10 fps; the rebuilt web client plays PCM via WebAudio.

Transport packet framing (binary WS message): one JSON header line + b"\\n"
+ raw payload.  The reference's ``MonitorTransportPacket`` bincode enum
(protocol/src/lib.rs:254-263) maps to header kinds init/audio/video.
"""

from __future__ import annotations

import json
import queue
import threading
import uuid as uuid_mod
from typing import Dict, Optional
import os

import numpy as np

from mixlab_tpu.av.codecs import (
    MONITOR_PICTURE,
    PngVideoEncoder,
    fmp4_capable,
)
from mixlab_tpu.av.encode_stream import f32_to_i16
from mixlab_tpu.engine.config import EngineConfig
from mixlab_tpu.video.frame import Picture
from mixlab_tpu.video.scale import scale_picture

# global socket map: uuid -> Broadcast of framed packets (monitor.rs:24-26)
_SOCKETS_LOCK = threading.Lock()
_SOCKETS: Dict[str, "PacketBroadcast"] = {}

SEGMENT_BROADCAST_DEPTH = 1024  # monitor.rs:214
VIDEO_TICK_DIVISOR = 6  # ~10 fps PNG preview in pcm+png mode


class PacketBroadcast:
    def __init__(self, init_packet: bytes, depth: int = SEGMENT_BROADCAST_DEPTH):
        self.init_packet = init_packet
        self._subs = []
        self._lock = threading.Lock()
        self._depth = depth

    def subscribe(self) -> "queue.Queue[bytes]":
        q: "queue.Queue[bytes]" = queue.Queue(maxsize=self._depth)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q):
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def send(self, packet: bytes):
        with self._lock:
            dead = []
            for q in self._subs:
                try:
                    q.put_nowait(packet)
                except queue.Full:
                    dead.append(q)  # lagged subscriber: drop it
            for q in dead:
                self._subs.remove(q)


def register_socket(socket_id: str, bc: PacketBroadcast):
    with _SOCKETS_LOCK:
        _SOCKETS[socket_id] = bc


def unregister_socket(socket_id: str):
    with _SOCKETS_LOCK:
        _SOCKETS.pop(socket_id, None)


def get_socket(socket_id: str) -> Optional[PacketBroadcast]:
    with _SOCKETS_LOCK:
        return _SOCKETS.get(socket_id)


def frame_packet(header: dict, payload: bytes = b"") -> bytes:
    return json.dumps(header, separators=(",", ":")).encode() + b"\n" + payload


class MonitorPipeline(threading.Thread):
    """Codec thread for one Monitor module (monitor.rs:185-251)."""

    def __init__(self, pipe, cfg: EngineConfig, mode: Optional[str] = None,
                 encoders: Optional[tuple] = None):
        super().__init__(daemon=True, name="monitor-codec")
        self.pipe = pipe
        self.cfg = cfg
        self.socket_id = str(uuid_mod.uuid4())
        self._stop_evt = threading.Event()
        if mode is None:
            mode = "fmp4" if fmp4_capable() else "pcm+png"
        self.mode = mode
        init = frame_packet(
            {
                "t": "init",
                "mode": "pcm+png",
                "sample_rate": cfg.sample_rate,
                "channels": cfg.channels,
                "video": "png",
                "width": MONITOR_PICTURE.width,
                "height": MONITOR_PICTURE.height,
            }
        )
        self.broadcast = PacketBroadcast(init)
        self._tick_count = 0
        # Codec construction is DEFERRED to the pipeline thread: building
        # the in-process libavcodec/libx264 encoders on the ENGINE thread
        # (module created by a live edit) would stall the tick loop for the
        # whole encoder set-up.
        self.video_enc = None
        self._encoders_arg = encoders
        self._codecs_ready = threading.Event()
        self.broadcast.ready = self._codecs_ready
        register_socket(self.socket_id, self.broadcast)

    def _ensure_codecs(self):
        """Idempotent codec setup, on the pipeline thread (not the engine
        thread — a live edit creating a Monitor must not pay shim/x264
        init inside the realtime tick)."""
        if self._codecs_ready.is_set():
            return
        if self.mode == "fmp4":
            self._init_fmp4(self._encoders_arg)
        else:
            # pcm+png only: PngVideoEncoder pre-builds a blank frame (a
            # device call) — don't pay that on the fmp4 tiers
            self.video_enc = PngVideoEncoder(MONITOR_PICTURE)
        self._codecs_ready.set()

    def _init_fmp4(self, encoders=None):
        """Real audio+AVC into the fragmented-MP4 mux for MSE playback —
        the reference's monitor path (monitor.rs:185-251).  Backend tier
        (av/codecs.py codec_tier): shim (libavcodec) > ffmpeg CLI > pure
        (zero-dep CAVLC H.264 + FLAC)."""
        from mixlab_tpu.av.codecs import codec_tier
        from mixlab_tpu.av.encode_stream import SAMPLES_PER_CHANNEL_PER_FRAGMENT

        fps = max(self.cfg.ticks_per_second // VIDEO_TICK_DIVISOR, 1)
        if encoders is not None:
            self._aac, self._h264 = encoders  # injected (tests)
        else:
            tier = codec_tier()
            if tier == "shim":
                # in-process libavcodec/libx264 (the reference's FFI shape)
                from mixlab_tpu.av.codecs import ShimAacStream, ShimH264Stream

                self._aac = ShimAacStream(self.cfg.sample_rate, bitrate=None)
                self._h264 = ShimH264Stream(
                    MONITOR_PICTURE, fps=fps, profile="monitor"
                )
            elif tier == "ffmpeg":
                from mixlab_tpu.av.codecs import FfmpegAacStream, FfmpegH264Stream

                self._aac = FfmpegAacStream(self.cfg.sample_rate, bitrate=None)
                self._h264 = FfmpegH264Stream(
                    MONITOR_PICTURE, fps=fps, profile="monitor"
                )
            else:
                from mixlab_tpu.av.h264enc import PureH264Stream

                # default pure audio is real AAC-LC since round 4
                # (av/aacenc.py) — the reference's monitor codec and what
                # MSE expects everywhere; FLAC (lossless) stays one env
                # knob away
                if os.environ.get("MIXLAB_PURE_AUDIO", "aac") == "flac":
                    from mixlab_tpu.av.flacenc import PureFlacStream

                    self._aac = PureFlacStream(
                        self.cfg.sample_rate, self.cfg.channels,
                        SAMPLES_PER_CHANNEL_PER_FRAGMENT,
                    )
                else:
                    from mixlab_tpu.av.codecs import PureAacStream

                    self._aac = PureAacStream(
                        self.cfg.sample_rate, self.cfg.channels
                    )
                self._h264 = PureH264Stream(
                    MONITOR_PICTURE, fps=fps, profile="monitor"
                )
        self._mux = None
        self._granule = SAMPLES_PER_CHANNEL_PER_FRAGMENT
        self._audio_frames = 0
        self._video_frames = 0
        # shim/pure encoders know their DCR at construction: emit the real
        # fmp4 init segment immediately so the FIRST subscriber sees it
        # (the reference sends init once, up front — monitor.rs:203-214);
        # only the ffmpeg-CLI tier must defer until SPS/PPS appear.
        self._try_create_mux()

    def _try_create_mux(self) -> bool:
        from mixlab_tpu.av import mp4

        if self._mux is not None:
            return True
        if getattr(self._h264, "dcr", None) is None:
            return False
        audio_is_flac = getattr(self._aac, "codec", "aac") == "flac"
        params = mp4.Mp4Params(
            timescale=self.cfg.sample_rate,
            width=MONITOR_PICTURE.width,
            height=MONITOR_PICTURE.height,
            dcr=self._h264.dcr,
            sample_rate=self.cfg.sample_rate,
            channels=self.cfg.channels,
            audio_codec="flac" if audio_is_flac else "aac",
            flac_streaminfo_block=(
                self._aac.streaminfo_block() if audio_is_flac else b""
            ),
        )
        self._mux, init_seg = mp4.Mp4Mux.create(params)
        # avc1.PPCCLL from the DCR's profile/compat/level bytes
        avc1 = "avc1.%02x%02x%02x" % (
            self._h264.dcr[1], self._h264.dcr[2], self._h264.dcr[3]
        )
        audio_codec = "flac" if audio_is_flac else "mp4a.40.2"
        self.broadcast.init_packet = frame_packet(
            {"t": "init", "mode": "fmp4",
             "mime": f'video/mp4; codecs="{avc1}, {audio_codec}"'},
            init_seg,
        )
        self.broadcast.send(self.broadcast.init_packet)
        return True

    def stop(self):
        self._stop_evt.set()
        unregister_socket(self.socket_id)

    def run(self):
        self._ensure_codecs()
        while not self._stop_evt.is_set():
            try:
                t0, audio, video = self.pipe.q.get(timeout=0.25)
            except queue.Empty:
                continue
            if self.mode == "fmp4":
                self._encode_tick_fmp4(t0, audio, video)
            else:
                self._encode_tick(t0, audio, video)

    def _encode_tick_fmp4(self, t0: int, audio: np.ndarray, video):
        self._ensure_codecs()
        from mixlab_tpu.av import mp4
        from mixlab_tpu.utils.mtime import MediaDuration

        self._aac.feed(f32_to_i16(audio.reshape(-1)))
        self._tick_count += 1
        if self._tick_count % VIDEO_TICK_DIVISOR == 0:
            pic = (
                scale_picture(video.picture, MONITOR_PICTURE)
                if video is not None
                else Picture.blank(MONITOR_PICTURE)
            )
            self._h264.feed(pic)

        units = self._h264.poll_access_units()
        if not self._try_create_mux():
            return  # ffmpeg tier: wait for SPS/PPS before the init segment

        audio_is_flac = self._mux.params.audio_codec == "flac"
        for frame in self._aac.poll_frames():
            dur = MediaDuration.new(self._granule, self.cfg.sample_rate)
            track = mp4.FlacFrame(frame) if audio_is_flac else mp4.AdtsFrame(frame)
            seg = self._mux.write_track(dur, track)
            self.broadcast.send(frame_packet({"t": "segment"}, seg))
        for is_key, payload in units:
            dur = MediaDuration.new(
                VIDEO_TICK_DIVISOR, self.cfg.ticks_per_second
            )
            seg = self._mux.write_track(
                dur,
                mp4.AvcFrame(is_key_frame=is_key, composition_time=MediaDuration.zero(), data=payload),
            )
            self.broadcast.send(frame_packet({"t": "segment"}, seg))

    def _encode_tick(self, t0: int, audio: np.ndarray, video):
        self._ensure_codecs()
        sr = self.cfg.sample_rate
        pcm = f32_to_i16(audio.reshape(-1)).astype("<i2").tobytes()
        self.broadcast.send(
            frame_packet(
                {"t": "audio", "pts": [int(t0), sr], "dur": [audio.shape[0], sr]},
                pcm,
            )
        )
        self._tick_count += 1
        if video is not None and self._tick_count % VIDEO_TICK_DIVISOR == 0:
            pic = scale_picture(video.picture, MONITOR_PICTURE)
            pkt = self.video_enc.encode(pic, pts=int(t0))[0]
            self.broadcast.send(
                frame_packet(
                    {"t": "video", "pts": [int(t0), sr], "key": True}, pkt.data
                )
            )
