#!/usr/bin/env python
"""Smoke test of mixlab's main paths on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-card paths only

One card, in order (the first failure exits non-zero):

  device          JAX must see GPU devices; there is no CPU fallback.  Then
                  the card's name and power limit from nvidia-smi.
  live server     ``python -m mixlab_tpu --listen`` in a subprocess (the one
                  process on the card; this process holds no device yet):
                  the flagship 16-module graph plus a video mixer built over
                  a WebSocket, a param and a structural edit, fMP4 segments
                  from /_monitor, /_metrics realtime over a window, zero
                  lost / re-dispatched / dropped device blocks, SIGTERM ->
                  exit 0 with the edits persisted.
  offline render  the flagship at 48 kHz in 480-tick blocks (384,000
                  samples) over 16 s, against the composed float64 oracle
                  (tests/oracle.py) and against the same program on the CPU.
  module kernels  EqThree and Envelope alone at 384,000 and 11,025 samples,
                  three blocks each, against the sequential oracles.
  video           the config4 composite (2 x 720p -> 1080p) and the video
                  mixer's two sources (1280x720, 960x540) through the
                  monitor's letterbox scale, against a float64 numpy resize;
                  the crossfade bit-exact against the integer formula.
  fleet           FleetEngine with 64 sessions at 15-tick blocks for 5 s;
                  every session's PCM against a single-session render of
                  its preset.

``--four``: the stem-parallel shard_map step with its psum mixdown, the
row-sharded crossfade, and the live Engine over a 4-device mesh, each
against the one-card result; then the Engine's own realtime thread over the
mesh through a structural edit's compile, warm run and swap.  Both Engine
runs fail on any lost, re-dispatched or dropped block.

Every phase prints its compile and run times and each comparison's maximum
error beside its tolerance (the reasons are in PERF.md).  The last line of
stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# tolerances (PERF.md "Tolerances" gives each reason)
EQ_TOL = 5e-5              # f32 cascade (HIGHEST matmuls) vs f64
ENV_TOL = 2e-4             # f32 positions/ms vs f64
RESIZE_LSB = 1             # the f32 resize route vs f64
SUM_TOL = 1e-5             # psum order across cards vs one card
GRAPH_REST_TOL = 1e-3      # the flagship's other f32 math vs f64
FM_AMP_HZ = 220.0          # the flagship FmSine's (880 - 440) / 2


def fm_phase_bound(t_end: float) -> float:
    """Worst-case error (radians, so also of the unit-amplitude output) of
    FmSine's f32 modulation phase f_amp * x * t at absolute time ``t_end``:
    the f32 time base plus two roundings of the product.  The reference
    computes it in f64; dsp/audio.py documents the deviation.  Two f32
    programs that round differently (GPU and CPU, or the vmapped fleet and
    a single session) may each be this far off, in opposite directions."""
    import numpy as np

    return 2 * np.pi * (FM_AMP_HZ * float(np.spacing(np.float32(t_end)))
                        + 2 * float(np.spacing(np.float32(FM_AMP_HZ * t_end))))


class PhaseFailed(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, tol: float, unit: str = "") -> None:
    say(f"  {name}: max error {err:.3e}{unit} (tolerance {tol:.1e}{unit})")
    if not err <= tol:
        raise PhaseFailed(f"{name}: {err} > {tol}")


def timed(fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t


def compile_and_run(jitted, *args):
    """-> (output, compile s, run s), the run ending in block_until_ready."""
    import jax

    compiled, t_compile = timed(lambda: jitted.lower(*args).compile())
    out, t_run = timed(lambda: jax.block_until_ready(compiled(*args)))
    return out, t_compile, t_run


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

_PROBE = ("import json, jax; d = jax.devices(); print(json.dumps({"
          "'platform': d[0].platform, 'kind': d[0].device_kind, "
          "'count': len(d)}))")


def phase_card() -> None:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in out.strip().splitlines():
        say(line.strip())


def phase_device(need: int) -> dict:
    """jax.devices() in a child process, so this one holds no device while
    the live server runs."""
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    if out.returncode != 0:
        raise PhaseFailed(f"device probe failed: {out.stderr[-2000:]}")
    dev = json.loads(out.stdout.strip().splitlines()[-1])
    say(f"  devices: {dev}")
    if dev["platform"] != "gpu":
        raise PhaseFailed(f"no GPU: JAX runs on {dev['platform']}")
    if dev["count"] < need:
        raise PhaseFailed(f"need {need} GPUs, JAX sees {dev['count']}")
    return dev


def in_process_device(need: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < need:
        raise PhaseFailed(f"in-process devices: {devs}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# live server
# ---------------------------------------------------------------------------


def phase_live_server(out_dir: Path) -> None:
    from bench import build_16_module_graph
    from mixlab_tpu import protocol as p
    from mixlab_tpu.server.live_client import drive_live, workspace_ops

    ws, mon = build_16_module_graph()
    n = len(ws.modules)
    ops = workspace_ops(ws)
    vm = p.ModuleId(n + 1)
    ops.append(p.CreateModule(p.ModuleParams(
        "VideoMixer", p.VideoMixerParams(a=0, b=1, fader=0.5)),
        p.WindowGeometry()))
    ops.append(p.CreateConnection(p.InputId(mon, 0), p.OutputId(vm, 0)))
    # param edit: the EqThree gains
    eq = next(m for m, e in ws.modules.items() if e.params.kind == "EqThree")
    ops.append(p.UpdateModuleParams(eq, p.ModuleParams(
        "EqThree", p.EqThreeParams(p.Decibel(-3.0), p.Decibel(1.0),
                                   p.Decibel(2.0)))))
    # structural edit: a new oscillator replaces mixer channel 8's input
    mixer = next(m for m, e in ws.modules.items() if e.params.kind == "Mixer")
    osc = p.ModuleId(n + 2)
    ops.append(p.CreateModule(p.ModuleParams(
        "Oscillator", p.OscillatorParams(330.0, p.Waveform.SAW)),
        p.WindowGeometry()))
    ops.append(p.CreateConnection(p.InputId(mixer, 7), p.OutputId(osc, 1)))

    with tempfile.TemporaryDirectory() as tmp:
        log_path = out_dir / "live_server.log"
        t = time.perf_counter()
        try:
            res = drive_live(str(Path(tmp) / "smoke.mixlab"), str(log_path),
                             ops, segments=20, metrics_seconds=6.0,
                             say=lambda m: say("  " + m))
        except Exception as e:
            tail = log_path.read_text(errors="replace")[-3000:] \
                if log_path.exists() else ""
            raise PhaseFailed(f"live server: {e}\n--- server log tail ---\n"
                              f"{tail}") from e
    log = log_path.read_text(errors="replace")
    for word in ("lost", "re-dispatching", "dropping block", "Traceback"):
        if word in log:
            raise PhaseFailed(f"server log mentions {word!r}")
    mods = res["persisted"].get("modules", {})
    kinds = [json.dumps(m.get("params")) for m in mods.values()]
    if len(mods) != n + 2:
        raise PhaseFailed(f"persisted {len(mods)} modules, want {n + 2}")
    if not any("330" in k and "Oscillator" in k for k in kinds):
        raise PhaseFailed("structural edit not persisted")
    if not any("EqThree" in k and "-3" in k for k in kinds):
        raise PhaseFailed("param edit not persisted")
    say(f"  boot {res['boot_s']:.1f} s (initial compile), segments "
        f"{res['segments']} in {res['segments_s']:.1f} s, faults "
        f"{res['faults']}, total {time.perf_counter() - t:.1f} s")


# ---------------------------------------------------------------------------
# offline render
# ---------------------------------------------------------------------------


def phase_offline_render() -> None:
    import jax
    import numpy as np

    import oracle
    from bench import build_16_module_graph
    from mixlab_tpu.dsp.base import interleave_tap
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.engine.scan_render import build_scanned, stacked_host_aux

    cfg = EngineConfig(sample_rate=48_000)
    block_ticks, n_ticks = 480, 960  # two 384,000-sample blocks = 16 s
    ws, mon = build_16_module_graph()
    patch, fn = build_scanned(ws, cfg, BlockSpec(block_ticks))
    args = (patch.prepare_aux(ws),
            stacked_host_aux(patch, 0, n_ticks // block_ticks),
            patch.init_state(ws))
    if "pallas_call" in str(jax.make_jaxpr(fn)(*args)):
        raise PhaseFailed("the render program holds a Pallas kernel")
    (_, taps), tc, tr = compile_and_run(fn, *args)
    got = interleave_tap(taps[str(mon.value)]["audio"]).reshape(-1, 2)
    say(f"  render {n_ticks / 60:.0f} s of audio: compile {tc:.1f} s, run "
        f"{tr * 1e3:.1f} ms ({n_ticks / 60 / tr:,.0f}x realtime)")
    want = oracle.flagship_16_module(got.shape[0], cfg.sample_rate)
    fm = fm_phase_bound(n_ticks / cfg.ticks_per_second)
    check("GPU vs float64 oracle", float(np.abs(got - want).max()),
          fm + GRAPH_REST_TOL)
    cpu = jax.devices("cpu")[0]
    (_, taps_c), tc, tr = compile_and_run(fn, *jax.device_put(args, cpu))
    got_c = interleave_tap(taps_c[str(mon.value)]["audio"]).reshape(-1, 2)
    say(f"  same program on the CPU: compile {tc:.1f} s, run {tr:.2f} s")
    check("GPU vs CPU", float(np.abs(got - got_c).max()), 2 * fm)


# ---------------------------------------------------------------------------
# module kernels
# ---------------------------------------------------------------------------


def _gate(S: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.empty(S, np.float32)
    pos = 0
    while pos < S:
        seg = int(rng.integers(5, 4000))
        x[pos:pos + seg] = rng.choice([0.0, 1.0, 0.5], p=[0.35, 0.35, 0.3])
        pos += seg
    return x


def phase_module_kernels() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    from mixlab_tpu.dsp.registry import get_def
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.protocol import Decibel, EnvelopeParams, EqThreeParams

    gains = (4.0, -2.0, 3.0)
    eq_params = EqThreeParams(*(Decibel(g) for g in gains))
    env_params = EnvelopeParams(attack_ms=3.0, decay_ms=40.0,
                                sustain_amplitude=0.6, release_ms=25.0)
    for sr, ticks in ((48_000, 480), (44_100, 15)):
        cfg = EngineConfig(sample_rate=sr)
        block = BlockSpec(ticks)
        S = block.n_samples(cfg)
        rng = np.random.default_rng(S)
        for kind, params in (("EqThree", eq_params), ("Envelope", env_params)):
            d = get_def(kind)
            aux = d.prepare(params, cfg)
            step = jax.jit(lambda st, x, d=d, aux=aux, params=params:
                           d.run_block(params, aux, None, st, [x], cfg,
                                       block)[:2])
            state = d.init_state(params, cfg)
            xs = [rng.uniform(-1, 1, S).astype(np.float32) if kind == "EqThree"
                  else _gate(S, S + i) for i in range(3)]
            compiled, tc = timed(
                lambda: step.lower(state, jnp.asarray(xs[0])).compile())
            got, t_run = [], 0.0
            for x in xs:
                (state, outs), tr = timed(
                    lambda: jax.block_until_ready(compiled(state, jnp.asarray(x))))
                t_run += tr
                got.append(np.asarray(outs[0]))
            got = np.concatenate(got)
            if kind == "EqThree":
                want, _ = oracle.eq_three(np.concatenate(xs), *gains, sr)
                tol = EQ_TOL
            else:
                want, _ = oracle.envelope(
                    0, np.concatenate(xs), env_params.attack_ms,
                    env_params.decay_ms, env_params.sustain_amplitude,
                    env_params.release_ms, sr)
                tol = ENV_TOL
            say(f"  {kind} {S:,} samples x 3 blocks @ {sr} Hz: compile "
                f"{tc:.2f} s, run {t_run / 3 * 1e3:.3f} ms/block")
            check(f"{kind} {S} vs oracle", float(np.abs(got - want).max()), tol)


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


def _np_resize(plane, oh: int, ow: int):
    """float64 reference resize through video/scale.py's resize_matrix."""
    import numpy as np

    from mixlab_tpu.video.scale import resize_matrix

    x = np.asarray(plane, np.float64)
    ih, iw = x.shape
    if ih != oh:
        x = resize_matrix(ih, oh).astype(np.float64) @ x
    if iw != ow:
        x = x @ resize_matrix(iw, ow).astype(np.float64).T
    return np.clip(np.round(x), 0, 255).astype(np.int64)


def _np_crossfade(a, b, fade: int):
    import numpy as np

    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    return (a * fade + b * (255 - fade)) // 255


def _np_letterbox(planes, inp, out):
    """float64 scale + letterbox of a yuv420p plane dict."""
    import numpy as np

    from mixlab_tpu.video.scale import letterbox_geometry

    x, y, sw, sh = letterbox_geometry(inp, out)
    res = {}
    for name, sub, fill in (("y", 0, 0), ("u", 1, 128), ("v", 1, 128)):
        canvas = np.full((out.height >> sub, out.width >> sub), fill, np.int64)
        ph, pw = sh >> sub, sw >> sub
        canvas[y >> sub:(y >> sub) + ph, x >> sub:(x >> sub) + pw] = \
            _np_resize(planes[name], ph, pw)
        res[name] = canvas
    return res


def phase_video() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mixlab_tpu.av.codecs import MONITOR_PICTURE, STREAM_PICTURE
    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.protocol import VideoMixerParams
    from mixlab_tpu.utils.mtime import MediaDuration
    from mixlab_tpu.video.blend import crossfade_xla
    from mixlab_tpu.video.colorspace import rgb_to_yuv420
    from mixlab_tpu.video.engine import VideoMixerState, video_mixer_tick
    from mixlab_tpu.video.frame import Picture, PictureSettings, VideoFrame
    from mixlab_tpu.video.pattern import gradient_rgb, smpte_bars_rgb
    from mixlab_tpu.video.scale import RESIZE_ROUTE, resize_plane, scale_picture

    say(f"  resize route: {RESIZE_ROUTE}")
    fade = 153

    # config4: two 720p patterns -> yuv420 -> 1080p -> crossfade
    def sources(t):
        return (rgb_to_yuv420(smpte_bars_rgb(1280, 720, phase=t)),
                rgb_to_yuv420(gradient_rgb(1280, 720, t=t)))

    def composite(t):
        a, b = sources(t)
        dims = ((1080, 1920), (540, 960), (540, 960))
        ra = tuple(resize_plane(p, h, w) for p, (h, w) in zip(a, dims))
        rb = tuple(resize_plane(p, h, w) for p, (h, w) in zip(b, dims))
        out = tuple(crossfade_xla(x, y, fade) for x, y in zip(ra, rb))
        return (a, b), ra, rb, out

    (src, ra, rb, out), tc, tr = compile_and_run(jax.jit(composite), 7)
    err = 0
    for i, (h, w) in enumerate(((1080, 1920), (540, 960), (540, 960))):
        for planes, resized in ((src[0], ra), (src[1], rb)):
            err = max(err, int(np.abs(np.asarray(resized[i], np.int64)
                                      - _np_resize(planes[i], h, w)).max()))
        # the crossfade itself: bit-exact on the device's own inputs
        if not np.array_equal(np.asarray(out[i], np.int64),
                              _np_crossfade(ra[i], rb[i], fade)):
            raise PhaseFailed(f"crossfade not bit-exact (plane {i})")
    say(f"  config4 composite: compile {tc:.2f} s, run {tr * 1e3:.3f} "
        "ms/frame; crossfade bit-exact")
    check("config4 resize vs float64", err, RESIZE_LSB, " LSB")

    # the video mixer's two sources through the monitor's letterbox scale
    rng = np.random.default_rng(0)

    def frame(w, h):
        planes = {"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
                  "u": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                  "v": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)}
        pic = Picture(PictureSettings(w, h),
                      {k: jnp.asarray(v) for k, v in planes.items()})
        return VideoFrame(picture=pic, duration_hint=MediaDuration.new(1, 30)), planes

    (f720, p720), (f540, p540) = frame(1280, 720), frame(960, 540)
    cfg = EngineConfig(sample_rate=44_100)
    params = VideoMixerParams(a=0, b=1, fader=0.5)
    mixed, t_mix = timed(lambda: jax.block_until_ready(video_mixer_tick(
        VideoMixerState(), params, [f720, f540], 0, cfg)[0].picture.planes))
    target = PictureSettings(1280, 720)
    b_ref = _np_letterbox(p540, PictureSettings(960, 540), target)
    mix_fade = int(params.fader * 255.0)
    err = max(int(np.abs(np.asarray(mixed[k], np.int64)
                         - _np_crossfade(p720[k], b_ref[k], mix_fade)).max())
              for k in ("y", "u", "v"))
    say(f"  video mixer 1280x720 + 960x540: {t_mix * 1e3:.1f} ms "
        "(first call, compile included)")
    check("video mixer vs float64", err, RESIZE_LSB, " LSB")
    mixed_np = {k: np.asarray(v) for k, v in mixed.items()}
    for out in (MONITOR_PICTURE, STREAM_PICTURE):
        scaled, t_sc = timed(lambda: jax.block_until_ready(
            scale_picture(Picture(target, mixed), out).planes))
        want = _np_letterbox(mixed_np, target, out)
        err = max(int(np.abs(np.asarray(scaled[k], np.int64) - want[k]).max())
                  for k in ("y", "u", "v"))
        say(f"  letterbox 1280x720 -> {out.width}x{out.height}: "
            f"{t_sc * 1e3:.1f} ms (first call, compile included)")
        check(f"letterbox {out.width}x{out.height} vs float64", err,
              RESIZE_LSB, " LSB")


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------


class _Collect:
    """A monitor subscriber that keeps every PCM packet."""

    def __init__(self):
        self.packets = []

    def push_threadsafe(self, pkt):
        self.packets.append(pkt)


def phase_fleet(n_sessions: int = 64, seconds: float = 5.0) -> None:
    import queue

    import numpy as np

    from bench import build_16_module_graph
    from mixlab_tpu import protocol as p
    from mixlab_tpu.engine.compiler import compile_patch
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.server.fleet_serve import FleetEngine

    cfg = EngineConfig(sample_rate=48_000)
    ticks = 15
    n_blocks = int(seconds * cfg.ticks_per_second / ticks)
    presets = (110.0, 137.5, 165.0, 192.5)  # per-session oscillator 1 freq
    tmpl, _ = build_16_module_graph()
    osc = next(m for m, e in tmpl.modules.items()
               if e.params.kind == "Oscillator")

    def preset_params(f):
        return p.ModuleParams("Oscillator",
                              p.OscillatorParams(f, p.Waveform.SINE))

    eng, t_boot = timed(lambda: FleetEngine(tmpl, n_sessions, cfg,
                                            block_ticks=ticks))
    say(f"  FleetEngine x{n_sessions}: build + compile + warm {t_boot:.1f} s")
    subs = []
    for i in range(n_sessions):
        done: queue.Queue = queue.Queue(maxsize=1)
        eng._process_cmd(("join", done))
        slot = done.get_nowait()
        eng._process_cmd(("op", slot, p.WorkspaceMessage(1, p.UpdateModuleParams(
            osc, preset_params(presets[i % len(presets)])))))
        sub = _Collect()
        slot.monitors.append(sub)
        subs.append(sub)
    times = []
    for _ in range(n_blocks + 1):  # issue-ahead: one extra block drains
        _, t = timed(eng._block_once)
        times.append(t)
    if any(eng.block_faults.values()):
        raise PhaseFailed(f"fleet block faults: {eng.block_faults}")
    block_s = ticks / cfg.ticks_per_second
    say(f"  {n_blocks} blocks ({n_blocks * block_s:.1f} s of audio per "
        f"session): median {np.median(times) * 1e3:.2f} ms/block "
        f"(budget {block_s * 1e3:.0f} ms), max {max(times) * 1e3:.2f} ms")

    def pcm(sub):
        blocks = [np.frombuffer(pkt.split(b"\n", 1)[1], np.int16).reshape(-1, 2)
                  for pkt in sub.packets[:n_blocks]]
        return np.concatenate(blocks)

    block = BlockSpec(ticks)
    refs = {}
    for f in presets:
        ws, _ = build_16_module_graph()
        ws.update_params(osc, preset_params(f))
        patch = compile_patch(ws, cfg, block)
        aux, state = patch.prepare_aux(ws), patch.init_state(ws)
        out = []
        for b in range(n_blocks):
            state, taps = patch.run(aux, patch.host_aux(b * block.n_samples(cfg)),
                                    state)
            (key,) = taps.keys()
            l, r = (np.asarray(c).reshape(-1) for c in taps[key]["audio"])
            out.append((np.clip(np.stack([l, r], -1), -1, 1) * 32767)
                       .astype(np.int16))
        refs[f] = np.concatenate(out).astype(np.int64)
    err, differing = 0, 0
    for i, sub in enumerate(subs):
        got = pcm(sub).astype(np.int64)
        if len(sub.packets) < n_blocks:
            raise PhaseFailed(f"session {i}: {len(sub.packets)} blocks")
        d = int(np.abs(got - refs[presets[i % len(presets)]]).max())
        err = max(err, d)
        differing += d > 0
    say(f"  sessions whose PCM differs from the single-session render: "
        f"{differing}/{n_sessions}")
    tol = int(np.ceil(2 * fm_phase_bound(n_blocks * block_s) * 32767)) + 1
    check("fleet PCM vs single-session render", err, tol, " LSB")
    # sessions of one preset are the same data in one program: bit-equal
    for k in range(len(presets)):
        same = [pcm(sub) for sub in subs[k::len(presets)]]
        if any(not np.array_equal(same[0], other) for other in same[1:]):
            raise PhaseFailed(f"sessions of preset {k} differ from each other")
    say("  sessions sharing a preset: bit-identical")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four(n_devices: int = 4) -> None:
    import jax
    import numpy as np

    from bench import build_16_module_graph
    from mixlab_tpu import protocol as p
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.engine.engine import Engine
    from mixlab_tpu.parallel.stems import (StemsPatch, make_mesh,
                                           row_sharded_blend,
                                           stem_parallel_step)
    from mixlab_tpu.video.blend import crossfade_xla

    mesh, mesh1 = make_mesh(n_devices), make_mesh(1)
    if len(mesh.devices.flat) != n_devices:
        raise PhaseFailed(f"mesh over {mesh.devices}")
    cfg = EngineConfig(sample_rate=48_000)
    block = BlockSpec(60)
    ws, mon = build_16_module_graph()

    # stem-parallel step, even (one stem per card) and uneven stem counts
    for n_stems in (n_devices, 2 * n_devices + 3):
        outs = {}
        for name, m in (("four", mesh), ("one", mesh1)):
            fn, make_args, _ = stem_parallel_step(
                ws, cfg, block, m, monitor_key=str(mon.value), n_stems=n_stems)
            (state, master), tc, tr = compile_and_run(fn, *make_args(0))
            outs[name] = np.asarray(master)
            if name == "four":
                leaf = jax.tree.leaves(state)[0]
                if len(leaf.sharding.device_set) != n_devices:
                    raise PhaseFailed(f"stem state on {leaf.sharding}")
            say(f"  stems x{n_stems} on {name} card(s): compile {tc:.1f} s, "
                f"run {tr * 1e3:.2f} ms")
        # each stem's f32 FM phase may round differently in the two programs
        tol = n_stems * 2 * fm_phase_bound(block.n_ticks / 60) + SUM_TOL
        check(f"stems x{n_stems}: four cards vs one",
              float(np.abs(outs["four"] - outs["one"]).max()), tol)

    # row-sharded crossfade over 1080p luma and odd heights
    rng = np.random.default_rng(0)
    blend = row_sharded_blend(mesh)
    for h in (1080, 1080 + 2, 540 - 3):
        a = rng.integers(0, 256, (h, 1920), dtype=np.uint8)
        b = rng.integers(0, 256, (h, 1920), dtype=np.uint8)
        (got, t) = timed(lambda: jax.block_until_ready(blend(a, b, 101)))
        one = np.asarray(jax.jit(crossfade_xla)(a, b, 101))
        if not np.array_equal(np.asarray(got), one):
            raise PhaseFailed(f"row-sharded crossfade differs at height {h}")
        say(f"  row-sharded crossfade {h}x1920: {t * 1e3:.1f} ms "
            "(compile included); bit-exact vs one card")

    def timed_dispatches(eng):
        """Time every block of ``eng``: -> [(patch, warmed, job s, block s)].
        The job is the device dispatch and fetch that DISPATCH_TIMEOUT
        bounds; the block adds the wait for the device lock, which an
        edit's compile and warm run hold.  Warmed: the program had run
        before (a cold one compiles inside its job, under a longer
        timeout)."""
        dispatches, jobs = [], []
        run_block, device_job = eng._run_block_resilient, eng._device_job

        def job(fn, timeout, _job=device_job):
            t = time.perf_counter()
            try:
                return _job(fn, timeout)
            finally:  # the compile worker's warm fetch is not a block's
                if threading.current_thread() is not eng._compile_worker:
                    jobs.append(time.perf_counter() - t)

        def run(host_aux, _run=run_block):
            patch = eng._patch
            warmed = getattr(patch, "_warmed", False)
            jobs.clear()
            t = time.perf_counter()
            out = _run(host_aux)
            dispatches.append((patch, warmed, sum(jobs),
                               time.perf_counter() - t))
            return out

        eng._device_job = job
        eng._run_block_resilient = run
        return dispatches

    def check_engine(eng, dispatches, name):
        """Zero block faults; each program compiled once (its warm run and
        every dispatch share one executable); every warmed device job under
        Engine.DISPATCH_TIMEOUT."""
        say(f"  {name}: block faults {eng.block_faults}")
        if any(eng.block_faults.values()):
            raise PhaseFailed(f"{name}: block faults {eng.block_faults}")
        patches = list(dict.fromkeys(d[0] for d in dispatches))
        compiles = [pt._fn._cache_size() for pt in patches]
        say(f"  {name}: {len(dispatches)} blocks over {len(patches)} "
            f"programs, compiles per program {compiles}")
        if any(c != 1 for c in compiles):
            raise PhaseFailed(f"{name}: a program compiled {compiles} times")
        for pt in patches[1:]:
            _, warmed, job, block = next(d for d in dispatches if d[0] is pt)
            say(f"  {name}: first block of the edited program: device job "
                f"{job * 1e3:.1f} ms, block {block * 1e3:.1f} ms ("
                + ("warmed off-thread" if warmed else "cold, compile included")
                + ")")
        warm = [d for d in dispatches if d[1]]
        job = max(d[2] for d in warm)
        say(f"  {name}: {len(warm)} warmed blocks: slowest device job "
            f"{job * 1e3:.1f} ms (limit: DISPATCH_TIMEOUT "
            f"{eng.DISPATCH_TIMEOUT:.1f} s), slowest block with its "
            f"device-lock wait {max(d[3] for d in warm) * 1e3:.1f} ms")
        if not job < eng.DISPATCH_TIMEOUT:
            raise PhaseFailed(f"{name}: a warmed device job took {job} s")

    def new_osc_edit(eng, sid, send):
        """A structural edit: an oscillator added and fed to the monitor."""
        before = set(eng.ws.modules)
        send(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator",
                           p.OscillatorParams(220.0, p.Waveform.SAW)),
            p.WindowGeometry())))
        deadline = time.monotonic() + 30
        while not set(eng.ws.modules) - before:
            if time.monotonic() > deadline:
                raise PhaseFailed("CreateModule not applied")
            time.sleep(0.01)
        (new,) = set(eng.ws.modules) - before
        send(sid, p.WorkspaceMessage(2, p.CreateConnection(
            p.InputId(mon, 1), p.OutputId(new, 1))))
        return new

    # the Engine over the mesh, driven block by block, a structural edit
    # mid-run: its monitor tap against the same on one card
    def engine_taps(m):
        eng = Engine(workspace=build_16_module_graph()[0], cfg=cfg,
                     block_ticks=2,
                     patch_compiler=StemsPatch.compiler(m, n_devices + 2))
        got = []
        route = eng._route_taps

        def record(t0, S, taps, video, _route=route):
            got.append(np.asarray(taps[str(mon.value)]["audio"][0]))
            return _route(t0, S, taps, video)

        eng._route_taps = record
        dispatches = timed_dispatches(eng)
        try:
            for _ in range(3):
                eng.tick_once()
            sid, _, _ = eng.connect_session()
            new = new_osc_edit(eng, sid, eng.client_update)
            for _ in range(3):
                eng.tick_once()
            if new not in eng._patch.order:
                raise PhaseFailed("structural edit not compiled in")
            leaf = jax.tree.leaves(eng._state)[0]
            if len(leaf.sharding.device_set) != len(m.devices.flat):
                raise PhaseFailed(f"engine state on {leaf.sharding}")
            check_engine(eng, dispatches,
                         f"engine over {len(m.devices.flat)} card(s)")
        finally:
            eng.stop()
        return np.concatenate(got)

    four, t4 = timed(engine_taps, mesh)
    one, t1 = timed(engine_taps, mesh1)
    say(f"  Engine over {n_devices} cards: {t4:.1f} s, one card "
        f"{t1:.1f} s (6 blocks and an edit each, compiles included)")
    tol = (n_devices + 2) * 2 * fm_phase_bound(6 * 2 / 60) + SUM_TOL
    check("Engine monitor tap: four cards vs one",
          float(np.abs(four - one).max()), tol)

    # the Engine's own 60 Hz thread over the mesh at the server's default
    # block: the edit compiles and warms off-thread and is swapped in, and
    # the engine's first dispatch of it runs under DISPATCH_TIMEOUT
    eng = Engine(workspace=build_16_module_graph()[0], cfg=cfg, block_ticks=4,
                 patch_compiler=StemsPatch.compiler(mesh, n_devices + 2))
    dispatches = timed_dispatches(eng)
    sid, _, _ = eng.connect_session()  # before the thread: answered at once
    t = time.perf_counter()
    eng.start()
    try:
        deadline = time.monotonic() + 300
        while len(dispatches) < 15:  # a second of blocks before the edit
            if time.monotonic() > deadline or not eng._thread.is_alive():
                raise PhaseFailed("realtime engine produced no blocks")
            time.sleep(0.05)
        new = new_osc_edit(eng, sid, eng.update)
        while new not in eng._patch.order:
            if time.monotonic() > deadline or not eng._thread.is_alive():
                raise PhaseFailed("realtime swap never adopted")
            time.sleep(0.05)
        n_swap = len(dispatches)
        while len(dispatches) < n_swap + 60:  # 4 s of blocks after the swap
            if time.monotonic() > deadline or not eng._thread.is_alive():
                raise PhaseFailed("engine stalled after the swap")
            time.sleep(0.05)
    finally:
        eng.stop()
    say(f"  realtime Engine over {n_devices} cards: {len(dispatches)} "
        f"blocks in {time.perf_counter() - t:.1f} s, edit swapped in")
    check_engine(eng, dispatches, f"realtime engine over {n_devices} cards")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args()
    need = 4 if args.four else 1
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    from mixlab_tpu.utils.platform import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    # build the host libraries now (g++ on first import), not later in a
    # codec thread whose compiler processes would outlive this one
    from mixlab_tpu import native
    from mixlab_tpu.native import avshim

    say(f"native runtime: {native.available()}, libavcodec shim: "
        f"{avshim.available()}")
    phases = [("device", lambda: phase_device(need)), ("card", phase_card)]
    if not args.four:
        phases.append(("live server", lambda: phase_live_server(out_dir)))
    t_all = time.perf_counter()
    for name, fn in phases:
        say(f"[{name}]")
        _, t = timed(fn)
        say(f"[{name}] ok in {t:.1f} s")

    dev = in_process_device(need)
    from mixlab_tpu.av.codecs import codec_tier

    say(f"codec tier: {codec_tier()}")
    if args.four:
        phases = [("four cards", phase_four)]
    else:
        phases = [("offline render", phase_offline_render),
                  ("module kernels", phase_module_kernels),
                  ("video", phase_video),
                  ("fleet", phase_fleet)]
    for name, fn in phases:
        say(f"[{name}]")
        _, t = timed(fn)
        say(f"[{name}] ok in {t:.1f} s")
    say(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": 4 if args.four else dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.enable()  # a crash prints every thread's stack
    try:
        rc = main()
    except Exception as e:  # any phase's failure: report, exit non-zero
        print(f"SMOKE FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        rc = 1
    sys.exit(rc)
