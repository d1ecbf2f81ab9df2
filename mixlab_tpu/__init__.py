"""mixlab_tpu — a digital audio/video workstation framework on an accelerator.

A ground-up rebuild of the capabilities of haileys/mixlab (a Rust web-based
DAW) designed for accelerator hardware: the patched module graph compiles into a
single jitted JAX program rendering many engine ticks per device dispatch;
IIR/envelope recurrences run as associative scans; video compositing runs as
XLA kernels; codecs, mux, networking and persistence run host-side.

Package map:
  engine/    graph, compiler, realtime engine loop, timing, config
  dsp/       audio module kernels (the reference's src/module/ DSP set)
  video/     frames, blend/scale/colorspace kernels, video tick engine
  av/        byte-exact bitstream + mux layers (ADTS, ASC, AVC DCR/NAL,
             FLV, fragmented MP4), codec backends
  io_host/   ingest/egress: listen-port disambiguation, RTMP, Icecast,
             source registry, throttles
  server/    HTTP/WebSocket server, session sync protocol
  parallel/  multi-chip sharding (stem-parallel and spatial video sharding)
  protocol/  shared wire types + serialization
  utils/     rational media time, misc
"""

__version__ = "0.1.0"
