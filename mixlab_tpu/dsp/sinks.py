"""Sink / tap / feed modules.

These bridge the jitted device program to host-side subsystems:

  * Plotter      — src/module/plotter.rs:38-59 (oscilloscope tap, every 6th
                   tick, device->host readback)
  * Monitor      — src/module/monitor.rs (A/V preview sink; audio tapped per
                   block, codec pipeline host-side)
  * OutputDevice — src/module/output_device.rs (soundcard sink; clip
                   detection on device, audio tap to the host audio backend)
  * StreamInput  — src/module/stream_input.rs (live ingest feed: host fills a
                   per-block i16 buffer from the ingest ring; i16->f32
                   conversion ÷32768 happens on device, stream_input.rs:167-173)
  * StreamOutput — src/module/stream_output.rs (RTMP egress; audio tap, codec
                   + network host-side)
  * MediaSource  — src/module/media_source.rs (file playback feed; host
                   decode thread fills per-block f32 buffers)

Taps are returned from the compiled block program as named arrays; the host
engine routes them to indications / codec pipelines, mirroring how the
reference's modules hand buffers to their codec threads over bounded queues.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.dsp.base import ModuleDef, expect_stereo
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import (
    LineType,
    MediaSourceParams,
    StreamInputParams,
    StreamOutputParams,
)


class PlotterDef(ModuleDef):
    kind = "Plotter"

    def terminals(self, params):
        return [LineType.STEREO.unlabeled()], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        taps = {}
        if inputs[0] is not None:
            # host slices every-6th-tick frames out of this (plotter.rs:40-42);
            # stereo taps cross to the host channel-major as the (L, R) pair
            l, r = inputs[0]
            shape = (block.n_ticks, cfg.samples_per_tick)
            taps["audio"] = (l.reshape(shape), r.reshape(shape))
        return state, [], taps


class MonitorDef(ModuleDef):
    kind = "Monitor"

    def terminals(self, params):
        # video first, audio second (monitor.rs:97-100)
        return [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[1], S)  # monitor sends zeros if unpatched
        shape = (block.n_ticks, cfg.samples_per_tick)
        taps = {"audio": (l.reshape(shape), r.reshape(shape))}
        return state, [], taps


class OutputDeviceDef(ModuleDef):
    kind = "OutputDevice"

    def terminals(self, params):
        return [LineType.STEREO.unlabeled()], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[0], S)
        # clip detection: any |sample| > 1.0 in the block
        # (output_device.rs:213-224 does this per engine tick on host; here it
        # is a device-side reduction, one bool per block)
        clip = jnp.any(jnp.abs(l) > 1.0) | jnp.any(jnp.abs(r) > 1.0)
        shape = (block.n_ticks, cfg.samples_per_tick)
        taps = {
            "audio": (l.reshape(shape), r.reshape(shape)),
            "clip": clip,
        }
        return state, [], taps


class _ExternalFeed(ModuleDef):
    """Base for modules whose audio originates host-side.

    The host fills a per-block buffer (declared via ``ext_spec``) which the
    compiled program receives as an input argument."""

    def ext_spec(self, params, cfg: EngineConfig, block: BlockSpec):
        """dict name -> (shape, dtype) of host-provided per-block arrays."""
        return {}


class StreamInputDef(_ExternalFeed):
    kind = "StreamInput"

    def terminals(self, params: StreamInputParams):
        # video first, audio second (stream_input.rs:45-48)
        return [], [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ]

    def ext_spec(self, params, cfg, block):
        # channel-major [2, S] so each channel lands as one full-lane row
        return {"pcm": ((2, block.n_samples(cfg)), np.int16)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        pcm = host_aux["pcm"]  # i16 [2,S] filled by host ingest path
        # convert_sample (stream_input.rs:167-173): i16 / 32768.0
        k = jnp.float32(1.0 / 32768.0)
        audio = (pcm[0].astype(jnp.float32) * k, pcm[1].astype(jnp.float32) * k)
        return state, [None, audio], {}


class MediaSourceDef(_ExternalFeed):
    kind = "MediaSource"

    def terminals(self, params: MediaSourceParams):
        # the reference emits only video (media_source.rs:52-55); the audio
        # output is a documented extension so WAV media is audible
        return [], [
            LineType.VIDEO.unlabeled(),
            LineType.STEREO.labeled("Audio"),
        ]

    def ext_spec(self, params, cfg, block):
        return {"pcm": ((2, block.n_samples(cfg)), np.float32)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        pcm = host_aux["pcm"]
        return state, [None, (pcm[0], pcm[1])], {}


class StreamOutputDef(ModuleDef):
    kind = "StreamOutput"

    def terminals(self, params: StreamOutputParams):
        # video first, audio second (stream_output.rs:48-51)
        return [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[1], S)
        shape = (block.n_ticks, cfg.samples_per_tick)
        taps = {"audio": (l.reshape(shape), r.reshape(shape))}
        return state, [], taps
