"""StreamOutput host controller: RTMP broadcast state machine + publish pipe.

Rebuild of ``src/module/stream_output.rs``:

  * impulse-encoded connect/disconnect params: an update is accepted only if
    ``seq`` increases; ``connect_seq == seq`` requests a connect,
    ``disconnect_seq == seq`` a disconnect; params cannot change while live
    (stream_output.rs:62-105);
  * connection state machine Offline -> Connecting -> Live | Failed with
    StreamOutputIndication updates (stream_output.rs:261-278);
  * when live, a publish thread drains the engine's bounded tick pipe
    (drop-on-lag, stream_output.rs:314-321) and sends FLV tags over the RTMP
    client with 1 kHz timestamps (stream_output.rs:373-406).

Codec gating: with the ffmpeg backend, audio is AAC CBR 160k and video x264
CBR 1.5 Mbps at 1120x700 (the reference operating point,
stream_output.rs:23-24,337-345); without it, audio publishes as linear-PCM
FLV tags (legal FLV sound format 3 — a capability the reference lacks) and
video is skipped.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from enum import Enum
from typing import Optional

import numpy as np

from mixlab_tpu import protocol as p
from mixlab_tpu.av import flv
from mixlab_tpu.av.encode_stream import f32_to_i16
from mixlab_tpu.engine.config import EngineConfig
from mixlab_tpu.io_host.rtmp import client as rtmp_client

log = logging.getLogger(__name__)

OUTPUT_WIDTH = 1120  # stream_output.rs:23
OUTPUT_HEIGHT = 700  # stream_output.rs:24


class ConnState(Enum):
    OFFLINE = "offline"
    CONNECTING = "connecting"
    LIVE = "live"
    FAILED = "failed"


def parse_rtmp_url(url: str):
    """rtmp://host[:port]/app -> (host, port, app)."""
    if not url.startswith("rtmp://"):
        raise ValueError("not an rtmp:// url")
    rest = url[len("rtmp://") :]
    hostport, _, app = rest.partition("/")
    host, _, port = hostport.partition(":")
    return host, int(port) if port else 1935, app or ""


class StreamOutputController:
    """One per StreamOutput module; owns an asyncio IO thread."""

    def __init__(self, pipe, cfg: EngineConfig, indicate=None):
        self.pipe = pipe
        self.cfg = cfg
        self.params = p.StreamOutputParams()
        self.state = ConnState.OFFLINE
        self.error = False
        self._indicate = indicate or (lambda ind: None)
        self._client: Optional[rtmp_client.RtmpPublishClient] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._io_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._epoch_samples: Optional[int] = None

    # -- indication --------------------------------------------------------

    def indication(self) -> p.StreamOutputIndication:
        live = {
            ConnState.OFFLINE: p.StreamOutputLiveStatus.OFFLINE,
            ConnState.FAILED: p.StreamOutputLiveStatus.OFFLINE,
            ConnState.CONNECTING: p.StreamOutputLiveStatus.CONNECTING,
            ConnState.LIVE: p.StreamOutputLiveStatus.LIVE,
        }[self.state]
        return p.StreamOutputIndication(live=live, error=self.error)

    def _set_state(self, state: ConnState, error: bool = False):
        self.state = state
        self.error = error
        self._indicate(p.Indication("StreamOutput", self.indication()))

    # -- impulse param updates (stream_output.rs:62-105) -------------------

    def update(self, new_params: p.StreamOutputParams) -> bool:
        if new_params.seq <= self.params.seq:
            return False  # out-of-date update
        if self.state in (ConnState.CONNECTING, ConnState.LIVE):
            if new_params.disconnect_seq == new_params.seq:
                self.params = new_params
                self.disconnect()
                return True
            return False  # cannot change params on a live output
        self.params = new_params
        if new_params.connect_seq == new_params.seq:
            self.connect()
            return True
        return False

    # -- connection lifecycle ----------------------------------------------

    def connect(self):
        self._set_state(ConnState.CONNECTING)
        self._stop.clear()
        self._io_thread = threading.Thread(
            target=self._run_io, daemon=True, name="stream-output-io"
        )
        self._io_thread.start()

    def disconnect(self):
        self._stop.set()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(lambda: None)
        self._set_state(ConnState.OFFLINE)

    def stop(self):
        self._stop.set()

    def _run_io(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            loop.run_until_complete(self._io_main())
        except Exception as e:
            log.warning("stream_output: connection failed: %s", e)
            self._set_state(ConnState.FAILED, error=True)
        finally:
            loop.close()
            self._loop = None

    async def _io_main(self):
        host, port, app = parse_rtmp_url(self.params.rtmp_url)
        client = await rtmp_client.start(host, port, app, self.params.rtmp_stream_key)
        self._client = client
        self._setup_encoders()
        if self._pure_video:
            # dedicated encode thread, depth-2 drop-on-lag (the reference's
            # codec-thread shape, monitor.rs:154-176): a slow frame costs a
            # dropped frame, never an audio stall
            self._venc_q = queue.Queue(maxsize=2)
            self._venc_thread = threading.Thread(
                target=self._video_encode_loop, daemon=True,
                name="stream-output-venc")
            self._venc_thread.start()
        self._set_state(ConnState.LIVE)
        self._epoch_samples = None
        self._tick_count = 0
        # sequence headers first (LiveOutput::start, stream_output.rs:336-371)
        if self._aac is not None:
            client.publish_audio(
                0, flv.AudioPacket(True, self._aac.configuration_data()).to_bytes()
            )
        if self._h264 is not None:
            client.publish_video(
                0,
                flv.VideoPacket(
                    flv.VideoFrameType.KEY_FRAME,
                    flv.VideoPacketType.SEQUENCE_HEADER,
                    0,
                    self._h264.dcr,
                ).to_bytes(),
            )
        # drain the engine tick pipe and publish until stopped
        while not self._stop.is_set():
            try:
                item = await asyncio.get_running_loop().run_in_executor(
                    None, self._pipe_get, 0.25
                )
            except Exception:
                break
            if item is None:
                continue
            t0, audio, video = item
            self._publish_tick(t0, audio, video)
        if self._venc_thread is not None:
            try:
                self._venc_q.put_nowait(None)
            except queue.Full:
                pass  # the thread also exits on self._stop
            self._venc_thread.join(timeout=2.0)
            self._venc_thread = None
        await client.close()
        self._client = None
        if self.state == ConnState.LIVE:
            self._set_state(ConnState.OFFLINE)

    def _setup_encoders(self):
        """AAC CBR 160k + x264 CBR 1.5 Mbps 30 fps at 1120x700 when the
        codec shim exists (the reference operating point,
        stream_output.rs:23-24, 337-345).  Zero-dep fallback since round
        4: pure AAC-LC audio (av/aacenc.py — FLV-standard, unlike the old
        PCM-FLV fallback which stays as the last resort) + pure CAVLC
        intra H.264 video at a reduced rate."""
        from mixlab_tpu.av.codecs import (
            STREAM_PICTURE,
            avshim_codecs_available,
        )

        self._aac = None
        self._h264 = None
        self._last_pic = None
        self._video_fps = 30
        self._pure_video = False
        self._venc_q: Optional[queue.Queue] = None
        self._venc_thread: Optional[threading.Thread] = None
        if avshim_codecs_available():
            from mixlab_tpu.av.codecs import ShimAacStream, ShimH264Stream

            try:
                self._aac = ShimAacStream(
                    self.cfg.sample_rate, bitrate=160_000
                )
                self._h264 = ShimH264Stream(
                    STREAM_PICTURE, fps=30, profile="stream"
                )
            except Exception as e:
                log.warning("stream_output: codec init failed: %s", e)
                self._aac = self._h264 = None
        if self._aac is None:
            from mixlab_tpu.av.codecs import PureAacStream

            try:
                # the reference broadcast op point: CBR 160 kb/s stereo
                # (stream_output.rs:337-345) — round 5's rate control +
                # reservoir hold the pure tier within a few percent of it
                self._aac = PureAacStream(self.cfg.sample_rate, 2,
                                          bitrate=160_000)
            except Exception as e:
                log.warning("stream_output: pure aac init failed (%s); "
                            "falling back to PCM-FLV", e)
        if self._h264 is None:
            from mixlab_tpu.av.h264cavlc_fast import NativeCavlcIntraEncoder
            from mixlab_tpu.av.h264enc import PureH264Stream

            try:
                self._h264 = PureH264Stream(
                    STREAM_PICTURE, fps=30, profile="stream", qp=32,
                )
                # The pure tier now runs the REFERENCE frame rate (30 fps,
                # stream_output.rs:216).  Round-5 profile of the pipeline
                # (tools/profile_pure_publish.py): the 15 fps cap was the
                # SCALE stage — the dense-matmul resize measured
                # 4.5 fps on host CPU; the banded host twin
                # (video/scale_host.py) does ~200 fps, the C++ encoder
                # ~100 fps, AAC-160k ~40% of one core.  Video runs on its
                # own encode thread (depth-2 drop-on-lag, the reference's
                # codec-thread shape, monitor.rs:154-176) so a slow frame
                # never stalls audio.  The numpy CAVLC fallback stays 5 fps.
                native = isinstance(self._h264._cavlc, NativeCavlcIntraEncoder)
                self._video_fps = 30 if native else 5
                self._pure_video = True
            except Exception as e:
                log.warning("stream_output: pure video init failed: %s", e)
                self._h264 = None

    def _pipe_get(self, timeout):
        try:
            return self.pipe.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _publish_tick(self, t0: int, audio: np.ndarray, video=None):
        if self._client is None:
            return
        if self._epoch_samples is None:
            self._epoch_samples = t0
        # RTMP timestamps on a 1 kHz timebase (stream_output.rs TIME_BASE)
        ts_ms = (t0 - self._epoch_samples) * 1000 // self.cfg.sample_rate
        if self._aac is None:
            pcm = f32_to_i16(audio.reshape(-1)).astype("<i2").tobytes()
            body = flv.pcm_s16le_tag(pcm, min(self.cfg.sample_rate, 44100))
            if not self._client.publish_audio(int(ts_ms), body):
                log.debug("stream_output: publish queue full, dropping tick")
        else:
            # real AAC path: granule pts is in samples since epoch -> ms
            self._aac.feed(f32_to_i16(audio.reshape(-1)))
            for frame in self._aac.poll_frames():
                # poll_frames wraps ADTS; RTMP wants raw AAC (rtmp/packet.rs)
                raw = frame[7:]
                if not self._client.publish_audio(
                    int(ts_ms), flv.AudioPacket(False, raw).to_bytes()
                ):
                    log.debug("stream_output: audio publish queue full")

        if self._h264 is not None:
            # shim: 30 fps (gop 60 = 2 s keyframes); pure native tier:
            # 30 fps on the encode thread; numpy fallback: 5 fps
            self._tick_count += 1
            divisor = max(self.cfg.ticks_per_second // self._video_fps, 1)
            due = self._tick_count % divisor == 0
            if self._pure_video:
                if due and self._venc_q is not None:
                    try:
                        self._venc_q.put_nowait((int(ts_ms), video))
                    except queue.Full:
                        log.debug("stream_output: video encode lagging; "
                                  "frame dropped")
                return
            if due:
                from mixlab_tpu.av.codecs import STREAM_PICTURE
                from mixlab_tpu.video.frame import Picture
                from mixlab_tpu.video.scale import scale_picture

                if video is not None:
                    pic = scale_picture(video.picture, STREAM_PICTURE)
                    self._last_pic = pic
                else:
                    # barrier semantics: repeat/blank so video never stalls
                    # audio (video/encode.rs:78-84)
                    pic = self._last_pic or Picture.blank(STREAM_PICTURE)
                self._h264.feed(pic)
            for is_key, avcc in self._h264.poll_access_units():
                body = flv.VideoPacket(
                    flv.VideoFrameType.KEY_FRAME if is_key
                    else flv.VideoFrameType.INTER_FRAME,
                    flv.VideoPacketType.NALU,
                    0,
                    avcc,
                ).to_bytes()
                if not self._client.publish_video(int(ts_ms), body):
                    log.debug("stream_output: video publish queue full")

    def _video_encode_loop(self):
        """Pure-tier video pipeline, off the IO loop: host-rate banded
        scale (video/scale_host.py) + C++ CAVLC encode; access units are
        posted back to the asyncio loop (the RTMP client's queue is not
        thread-safe from here)."""
        import numpy as np

        from mixlab_tpu.av.codecs import STREAM_PICTURE
        from mixlab_tpu.video.frame import Picture
        from mixlab_tpu.video.scale_host import scale_picture_host

        blank = None
        while not self._stop.is_set():
            try:
                item = self._venc_q.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is None:
                break
            ts_ms, video = item
            try:
                if video is not None:
                    src = video.picture
                    src = Picture(src.settings, {
                        k: np.asarray(v) for k, v in src.planes.items()})
                    pic = scale_picture_host(src, STREAM_PICTURE)
                    self._last_pic = pic
                else:
                    if self._last_pic is None and blank is None:
                        blank = Picture(STREAM_PICTURE, {
                            "y": np.zeros((STREAM_PICTURE.height,
                                           STREAM_PICTURE.width), np.uint8),
                            "u": np.full((STREAM_PICTURE.height // 2,
                                          STREAM_PICTURE.width // 2),
                                         0x80, np.uint8),
                            "v": np.full((STREAM_PICTURE.height // 2,
                                          STREAM_PICTURE.width // 2),
                                         0x80, np.uint8)})
                    pic = self._last_pic or blank
                self._h264.feed(pic)
                units = list(self._h264.poll_access_units())
            except Exception:
                log.exception("stream_output: pure video encode failed; "
                              "frame dropped")
                continue
            loop, client = self._loop, self._client
            if loop is None or client is None:
                continue
            for is_key, avcc in units:
                body = flv.VideoPacket(
                    flv.VideoFrameType.KEY_FRAME if is_key
                    else flv.VideoFrameType.INTER_FRAME,
                    flv.VideoPacketType.NALU, 0, avcc).to_bytes()
                try:
                    loop.call_soon_threadsafe(
                        client.publish_video, ts_ms, body)
                except RuntimeError:
                    break  # loop closed mid-shutdown
