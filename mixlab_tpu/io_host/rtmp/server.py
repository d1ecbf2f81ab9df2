"""RTMP ingest server (publish side).

Rebuild of ``src/rtmp/mod.rs`` + ``src/rtmp/incoming.rs``: accept a
publisher (OBS/ffmpeg), run the handshake, answer connect/createStream/
publish over AMF0, bind the publish app name to a mountpoint in the RTMP
registry, then route FLV audio/video tag bodies:

  * AAC sequence header -> AudioSpecificConfiguration (rtmp/mod.rs:205-216)
  * AAC raw -> decode to i16 stereo PCM -> ``write_audio(MediaTime(ts,1000))``
    (TIME_BASE = 1000, rtmp/mod.rs:42)
  * AVC sequence header -> DecoderConfigurationRecord (rtmp/mod.rs:277-287)
  * AVC NALU -> decode to a video frame -> ``write_video``

Decode is routed through a pluggable ``MediaDecoder``.  The default is
``ShimDecoder`` — AAC + H.264 via the in-process ffmpeg-libraries shim
(native/avshim.py), matching the reference's fdk-aac/ffmpeg FFI on the
blocking receive thread (rtmp/mod.rs:192-338).  On images without the
libraries, payloads are parsed but dropped with a one-time warning.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from mixlab_tpu.av import flv
from mixlab_tpu.av.aac import AudioSpecificConfiguration
from mixlab_tpu.av.avc import DecoderConfigurationRecord
from mixlab_tpu.io_host import source as source_mod
from mixlab_tpu.io_host.rtmp import amf0
from mixlab_tpu.io_host.rtmp.chunk import (
    MSG_AUDIO,
    MSG_COMMAND_AMF0,
    MSG_DATA_AMF0,
    MSG_VIDEO,
    ChunkReader,
    ChunkWriter,
    Message,
)
from mixlab_tpu.io_host.rtmp.handshake import server_handshake
from mixlab_tpu.utils.mtime import MediaTime, TimeBase

log = logging.getLogger(__name__)

TIME_BASE = TimeBase.new(1, 1000)  # rtmp/mod.rs:42


def listen(mountpoint: str):
    """Called by stream_input modules."""
    return source_mod.RTMP_MOUNTPOINTS.listen(mountpoint)


class MediaDecoder:
    """Decode interface; see module docstring."""

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        pass

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        pass

    def decode_audio(self, raw_aac: bytes) -> Optional[np.ndarray]:
        """-> i16 [n, 2] PCM or None."""
        return None

    def decode_mp3(self, frame: bytes) -> Optional[np.ndarray]:
        """-> i16 [n, 2] PCM or None (FLV sound format 2)."""
        return None

    def decode_video(self, packet: flv.VideoPacket):
        """-> mixlab_tpu.video.frame.VideoFrame or None."""
        return None


class NullDecoder(MediaDecoder):
    def __init__(self):
        self._warned = False

    def _warn(self):
        if not self._warned:
            self._warned = True
            log.warning(
                "rtmp: no AAC/H.264 decoder backend available; "
                "ingest media is parsed but dropped"
            )

    def decode_audio(self, raw_aac):
        self._warn()
        return None

    def decode_video(self, packet):
        self._warn()
        return None


class ShimDecoder(MediaDecoder):
    """AAC + H.264 ingest decode via the in-process ffmpeg-libraries shim
    (native/avshim.py) — the reference's exact shape: fdk-aac/ffmpeg FFI on
    the blocking receive thread (rtmp/mod.rs:192-338)."""

    def __init__(self):
        self._adec = None
        self._vdec = None
        self._mp3dec = None
        self.video_duration_hint = None  # set by _on_video from ts deltas

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        from mixlab_tpu.native import avshim

        self._adec = avshim.AudioDecoder("aac", asc.to_bytes())

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        from mixlab_tpu.native import avshim

        self._vdec = avshim.VideoDecoder("h264", dcr.to_bytes())

    def decode_audio(self, raw_aac: bytes):
        if self._adec is None:
            return None
        out = []
        for _pts, pcm, _rate in self._adec.decode(raw_aac):
            # force stereo like the reference (rtmp/mod.rs:229-231)
            if pcm.shape[1] == 1:
                pcm = np.repeat(pcm, 2, axis=1)
            out.append(pcm[:, :2])
        return np.concatenate(out) if out else None

    def decode_mp3(self, frame: bytes):
        from mixlab_tpu.native import avshim

        if self._mp3dec is None:
            if not avshim.have_decoder("mp3"):
                return None
            self._mp3dec = avshim.AudioDecoder("mp3")
        out = []
        for _pts, pcm, _rate in self._mp3dec.decode(frame):
            if pcm.shape[1] == 1:
                pcm = np.repeat(pcm, 2, axis=1)
            out.append(pcm[:, :2])
        return np.concatenate(out) if out else None

    def decode_video(self, packet: flv.VideoPacket):
        if self._vdec is None:
            return None
        from mixlab_tpu.engine.media_player import _upload_planes
        from mixlab_tpu.utils.mtime import MediaDuration
        from mixlab_tpu.video.frame import Picture, PictureSettings, VideoFrame

        frames = self._vdec.decode(packet.data)
        if not frames:
            return None
        _pts, y, u, v = frames[-1]
        h, w = y.shape
        pic = Picture(PictureSettings(w, h), _upload_planes(y, u, v))
        hint = self.video_duration_hint or MediaDuration.new(1, 30)
        return VideoFrame(picture=pic, duration_hint=hint)


class PureTierDecoder(MediaDecoder):
    """Zero-dependency ingest tier: H.264 video through the pure decoder
    (av/h264dec.py — full intra AND inter P slices, CAVLC and CABAC,
    i.e. what default x264/OBS publishers actually send, with C++ twins
    at realtime+ rates), AAC-LC audio through the pure decoder
    (av/aacdec.py, tables recovered clean-room by
    tools/extract_aac_tables.py) — no codec libraries at all.  The
    reference simply fails to build without ffmpeg/fdk
    (rtmp/mod.rs:192-338)."""

    def __init__(self):
        self._vdec = None
        self._adec = None
        self._asc = None
        self.video_duration_hint = None

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        from mixlab_tpu.av.h264dec import PureH264Decoder

        self._vdec = PureH264Decoder(dcr.to_bytes())

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        from mixlab_tpu.av.aacdec import AacLcDecoder

        self._asc = asc
        self._adec = AacLcDecoder(asc)

    def decode_audio(self, raw_aac: bytes):
        if self._adec is None:
            return None
        from mixlab_tpu.av.aacdec import AacDecodeError

        try:
            pcm = self._adec.decode_raw(
                raw_aac, self._asc.sampling_frequency_index
            )
        except AacDecodeError as e:
            log.warning("rtmp: pure aac decode failed: %s", e)
            return None
        out = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
        if out.shape[1] == 1:  # force stereo like the reference
            out = np.repeat(out, 2, axis=1)
        return out[:, :2]

    def decode_video(self, packet: flv.VideoPacket):
        if self._vdec is None:
            return None
        from mixlab_tpu.engine.media_player import _upload_planes
        from mixlab_tpu.utils.mtime import MediaDuration
        from mixlab_tpu.video.frame import Picture, PictureSettings, VideoFrame

        try:
            frames = self._vdec.decode(packet.data)
        except Exception as e:
            log.warning("rtmp: pure h264 decode failed: %s", e)
            return None
        if not frames:
            return None
        _pts, y, u, v = frames[-1]
        h, w = y.shape
        pic = Picture(PictureSettings(w, h), _upload_planes(y, u, v))
        hint = self.video_duration_hint or MediaDuration.new(1, 30)
        return VideoFrame(picture=pic, duration_hint=hint)


def default_decoder_factory() -> MediaDecoder:
    from mixlab_tpu.av.codecs import ffmpeg_available
    from mixlab_tpu.native import avshim

    if (
        avshim.available()
        and avshim.have_decoder("aac")
        and avshim.have_decoder("h264")
    ):
        return ShimDecoder()
    if ffmpeg_available():
        try:
            from mixlab_tpu.io_host.rtmp.ffmpeg_decode import FfmpegDecoder

            return FfmpegDecoder()
        except Exception:
            pass
    return PureTierDecoder()


# test/instrumentation hook
DECODER_FACTORY: Callable[[], MediaDecoder] = default_decoder_factory


async def accept(reader, writer):
    """Handle one RTMP connection end-to-end (rtmp/mod.rs:59-104)."""
    await server_handshake(reader, writer)
    cr = ChunkReader(reader)
    cw = ChunkWriter(writer)

    app_name: Optional[str] = None
    send: Optional[source_mod.SourceSend] = None
    decoder = DECODER_FACTORY()

    def reply(name, transaction_id, *args):
        cw.write_message(
            Message(0, MSG_COMMAND_AMF0, 0, amf0.encode_all(name, transaction_id, *args))
        )

    try:
        while True:
            msg = await cr.read_message()
            if msg is None:
                break
            if msg.type_id == MSG_COMMAND_AMF0:
                try:
                    values = amf0.decode_all(msg.payload)
                except amf0.Amf0Error:
                    break  # malformed command message: disconnect cleanly
                cmd = values[0] if values else None
                txn = values[1] if len(values) > 1 else 0
                if not isinstance(txn, (int, float)):
                    txn = 0
                if cmd == "connect":
                    props = values[2] if len(values) > 2 else {}
                    if not isinstance(props, dict):
                        props = {}  # AMF0 allows any type here
                    app_name = props.get("app", "")
                    if not isinstance(app_name, str):
                        app_name = ""
                    reply(
                        "_result",
                        txn,
                        {
                            "fmsVer": "mixlab/0.1",
                            "capabilities": 31.0,
                        },
                        {
                            "level": "status",
                            "code": "NetConnection.Connect.Success",
                            "description": "Connection succeeded.",
                        },
                    )
                    await writer.drain()
                elif cmd == "createStream":
                    reply("_result", txn, None, 1.0)
                    await writer.drain()
                elif cmd in ("releaseStream", "FCPublish", "FCUnpublish"):
                    pass
                elif cmd == "publish":
                    # stream key = values[3]; the mountpoint is the app name
                    # (rtmp/mod.rs:73: MOUNTPOINTS.connect(app name))
                    try:
                        send = source_mod.RTMP_MOUNTPOINTS.connect(app_name or "")
                    except source_mod.ConnectError as e:
                        reply(
                            "onStatus",
                            0,
                            None,
                            {
                                "level": "error",
                                "code": "NetStream.Publish.BadName",
                                "description": str(e),
                            },
                        )
                        await writer.drain()
                        break
                    reply(
                        "onStatus",
                        0,
                        None,
                        {
                            "level": "status",
                            "code": "NetStream.Publish.Start",
                            "description": "Publishing.",
                        },
                    )
                    await writer.drain()
                elif cmd == "deleteStream":
                    break
            elif msg.type_id == MSG_AUDIO and send is not None:
                _on_audio(msg, send, decoder)
            elif msg.type_id == MSG_VIDEO and send is not None:
                _on_video(msg, send, decoder)
            elif msg.type_id == MSG_DATA_AMF0:
                pass  # onMetaData etc.
    finally:
        if send is not None:
            send.close()


def _on_audio(msg: Message, send, decoder: MediaDecoder):
    import numpy as np

    try:
        kind, data = flv.parse_audio_tag(msg.payload)
    except flv.FlvError as e:
        log.warning("rtmp: bad audio tag: %s", e)
        return
    if kind == "aac_seq":
        try:
            decoder.set_audio_config(AudioSpecificConfiguration.parse(data))
        except Exception as e:
            log.warning("rtmp: bad ASC: %s", e)
        return
    if kind == "mp3":
        pcm = decoder.decode_mp3(data)
        if pcm is not None and len(pcm):
            send.write_audio(TIME_BASE.scale_timestamp(msg.timestamp), pcm)
        return
    if kind == "pcm_s16le":
        # codec-less linear PCM path (extension of this build; see av/flv.py)
        x = np.frombuffer(data, dtype="<i2")
        pcm = x.reshape(-1, 2) if len(x) % 2 == 0 else np.stack([x, x], -1)
        send.write_audio(TIME_BASE.scale_timestamp(msg.timestamp), pcm)
        return
    pcm = decoder.decode_audio(data)
    if pcm is not None and len(pcm):
        send.write_audio(TIME_BASE.scale_timestamp(msg.timestamp), pcm)


def _on_video(msg: Message, send, decoder: MediaDecoder):
    try:
        pkt = flv.VideoPacket.parse(msg.payload)
    except flv.FlvError as e:
        log.warning("rtmp: bad video tag: %s", e)
        return
    if pkt.packet_type == flv.VideoPacketType.SEQUENCE_HEADER:
        try:
            decoder.set_video_config(DecoderConfigurationRecord.parse(pkt.data))
        except Exception as e:
            log.warning("rtmp: bad DCR: %s", e)
        return
    if pkt.packet_type == flv.VideoPacketType.END_OF_SEQUENCE:
        return
    # estimate the frame duration from timestamp deltas so the video mixer's
    # expiry window (video_mixer.rs:94-148) holds the frame exactly one
    # frame interval
    last_ts = getattr(decoder, "_last_video_ts", None)
    if last_ts is not None and msg.timestamp > last_ts:
        from mixlab_tpu.utils.mtime import MediaDuration

        decoder.video_duration_hint = MediaDuration.new(
            msg.timestamp - last_ts, 1000
        )
    decoder._last_video_ts = msg.timestamp
    frame = decoder.decode_video(pkt)
    if frame is not None:
        # presentation time = dts + composition time (rtmp/mod.rs:318-322)
        pts_ms = msg.timestamp + pkt.composition_time
        send.write_video(TIME_BASE.scale_timestamp(pts_ms), frame)
