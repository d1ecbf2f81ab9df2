"""Plain-XLA times and device traces of the main paths on a GPU.

    python tools/profile_gpu.py [--out chiprun_out/profile]

Times (median of several runs, each ending in block_until_ready, compile
excluded) of: the flagship render block (48 kHz, 480 ticks = 384,000
samples), EqThree and Envelope alone at 384,000 / 12,000 / 11,025 samples,
the fleet serving step (FleetEngine, 15-tick blocks) at 64 and 256
sessions, the config4 composite per resize candidate, each candidate at the
config4 / monitor / broadcast shapes with its LSB error against float64,
and the 1080p crossfade.  The candidates are the declared route ("f32",
TF32 on an H100), "int8" (s8 x s8 -> s32), and "f32_highest", a full-f32
resize kept here only for this comparison.  Then one profiler trace each of the flagship
render, the fleet step and the config4 composite, reduced to device busy
time and the kernels that take it (written under ``--out``).
"""

from __future__ import annotations

import argparse
import glob
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def med_time(fn, reps: int = 7) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t)
    return statistics.median(ts)


def resize_f32_highest(plane, out_h: int, out_w: int):
    """video/scale.py's f32 resize with full-f32 (HIGHEST) matmuls."""
    import jax.numpy as jnp

    from mixlab_tpu.video.scale import resize_matrix

    in_h, in_w = plane.shape
    x = plane.astype(jnp.float32)
    if in_h != out_h:
        x = jnp.einsum("oi,iw->ow", jnp.asarray(resize_matrix(in_h, out_h)),
                       x, preferred_element_type=jnp.float32,
                       precision="highest")
    if in_w != out_w:
        x = jnp.einsum("hw,ow->ho", x, jnp.asarray(resize_matrix(in_w, out_w)),
                       preferred_element_type=jnp.float32, precision="highest")
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


def resize_candidates():
    """name -> resize(plane, out_h, out_w) for each candidate route."""
    from mixlab_tpu.video.scale import resize_plane

    return {"f32": lambda x, h, w: resize_plane(x, h, w, "f32"),
            "f32_highest": resize_f32_highest,
            "int8": lambda x, h, w: resize_plane(x, h, w, "int8")}


def reduce_trace(trace_dir: str) -> dict:
    """Device busy time and the top kernels of one trace: busy is the union
    of kernel intervals on the device's stream lines; kernels are summed by
    name."""
    from jax.profiler import ProfileData

    paths = glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb")
    if not paths:
        return {"error": "no trace written"}
    pd = ProfileData.from_file(paths[0])
    out = {"lines": {}, "top": []}
    by_name, intervals = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            out["lines"][f"{plane.name}|{line.name}"] = (
                len(evs), sum(e.duration_ns for e in evs) / 1e6)
            if "stream" not in line.name.lower():
                continue
            for e in evs:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    intervals.sort()
    busy, end, first = 0.0, None, None
    for s, e in intervals:
        first = s if first is None else first
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    out["busy_ms"] = busy / 1e6
    out["span_ms"] = ((end - first) / 1e6) if intervals else 0.0
    total = sum(by_name.values()) or 1.0
    out["top"] = [(n, d / 1e6, d / total) for n, d in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:15]]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from mixlab_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_16_module_graph
    from mixlab_tpu.dsp.registry import get_def
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.engine.scan_render import build_scanned, stacked_host_aux
    from mixlab_tpu.protocol import Decibel, EnvelopeParams, EqThreeParams
    from mixlab_tpu.server.fleet_serve import FleetEngine
    from mixlab_tpu.video.blend import crossfade_xla
    from mixlab_tpu.video.colorspace import rgb_to_yuv420
    from mixlab_tpu.video.pattern import gradient_rgb, smpte_bars_rgb
    from mixlab_tpu.video.scale import resize_matrix

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = jax.devices()[0]
    res = {"card": card, "platform": dev.platform, "kind": dev.device_kind,
           "count": len(jax.devices())}
    print(json.dumps(res), flush=True)

    # -- flagship render block ----------------------------------------------
    cfg48 = EngineConfig(sample_rate=48_000)
    ws, _ = build_16_module_graph()
    patch, fn = build_scanned(ws, cfg48, BlockSpec(480), checksum_only=True)
    fargs = (patch.prepare_aux(ws), stacked_host_aux(patch, 0, 2),
             patch.init_state(ws))
    t = med_time(lambda: fn(*fargs)) / 2
    res["flagship_block_480_ms"] = t * 1e3
    res["flagship_x_realtime"] = 8.0 / t
    print(f"flagship 480-tick block: {t * 1e3:.3f} ms "
          f"({8.0 / t:,.0f}x realtime)", flush=True)

    # -- modules alone ------------------------------------------------------
    eq_p = EqThreeParams(Decibel(4.0), Decibel(0.0), Decibel(4.0))
    env_p = EnvelopeParams()
    for sr, ticks in ((48_000, 480), (48_000, 15), (44_100, 15)):
        cfg = EngineConfig(sample_rate=sr)
        block = BlockSpec(ticks)
        S = block.n_samples(cfg)
        x = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, S)
                        .astype(np.float32))
        for kind, params in (("EqThree", eq_p), ("Envelope", env_p)):
            d = get_def(kind)
            aux, st = d.prepare(params, cfg), d.init_state(params, cfg)
            f = jax.jit(lambda st, x, d=d, aux=aux, params=params, cfg=cfg,
                        block=block: d.run_block(params, aux, None, st, [x],
                                                 cfg, block)[:2])
            t = med_time(lambda: f(st, x))
            res[f"{kind}_{S}_ms"] = t * 1e3
            print(f"{kind} alone, {S} samples: {t * 1e3:.4f} ms", flush=True)

    # -- fleet step ---------------------------------------------------------
    fleets = {}
    for n in (64, 256):
        eng = FleetEngine(ws, n, cfg48, block_ticks=15)
        h = eng.fleet.host_aux(0)
        mask = np.zeros(n, dtype=bool)
        step = lambda eng=eng, h=h, mask=mask: eng._step(
            eng.fleet.aux, h, eng.fleet.state, mask)
        t = med_time(step)
        fleets[n] = step
        res[f"fleet_step_{n}_ms"] = t * 1e3
        print(f"fleet step, {n} sessions x 15 ticks: {t * 1e3:.3f} ms "
              "(budget 250 ms)", flush=True)

    # -- video --------------------------------------------------------------
    candidates = resize_candidates()

    def composite(t, method, batch=8):
        resize = candidates[method]

        def one(t):
            outs = []
            for rgb in (smpte_bars_rgb(1280, 720, phase=t),
                        gradient_rgb(1280, 720, t=t)):
                y, u, v = rgb_to_yuv420(rgb)
                outs.append((resize(y, 1080, 1920), resize(u, 540, 960),
                             resize(v, 540, 960)))
            return tuple(crossfade_xla(a, b, 153)
                         for a, b in zip(outs[0], outs[1]))
        return jax.vmap(one)(t + jnp.arange(batch))

    comps = {}
    for m in candidates:
        f = jax.jit(lambda t, m=m: composite(t, m))
        t = med_time(lambda f=f: f(3)) / 8
        comps[m] = f
        res[f"config4_{m}_ms_per_frame"] = t * 1e3
        print(f"config4 composite [{m}]: {t * 1e3:.4f} ms/frame", flush=True)

    rng = np.random.default_rng(1)
    shapes = {"config4_y": ((720, 1280), (1080, 1920)),
              "config5_y": ((540, 960), (1080, 1920)),
              "monitor_y": ((720, 1280), (350, 560)),
              "broadcast_y": ((1080, 1920), (700, 1120))}
    for name, ((ih, iw), (oh, ow)) in shapes.items():
        plane = rng.integers(0, 256, (ih, iw), dtype=np.uint8)
        ref = np.clip(np.round(resize_matrix(ih, oh).astype(np.float64)
                               @ plane.astype(np.float64)
                               @ resize_matrix(iw, ow).astype(np.float64).T),
                      0, 255)
        xp = jnp.asarray(plane)
        for m, resize in candidates.items():
            f = jax.jit(lambda x, r=resize: r(x, oh, ow))
            t = med_time(lambda f=f: f(xp), reps=15)
            err = int(np.abs(np.asarray(f(xp)) - ref).max())
            res[f"resize_{name}_{m}"] = {"ms": t * 1e3, "lsb": err}
            print(f"resize {name} {ih}x{iw}->{oh}x{ow} [{m}]: "
                  f"{t * 1e3:.4f} ms, {err} LSB", flush=True)

    a = jnp.asarray(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8))
    b = jnp.asarray(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8))
    xf = jax.jit(lambda a, b: crossfade_xla(a, b, 99))
    t = med_time(lambda: xf(a, b)) / 8
    res["crossfade_1080p_luma_ms"] = t * 1e3
    print(f"crossfade 1080p luma: {t * 1e3:.4f} ms/frame", flush=True)

    # -- traces -------------------------------------------------------------
    for name, fn_ in (("flagship_render_2x480", lambda: fn(*fargs)),
                      ("fleet_step_64", fleets[64]),
                      ("config4_composite_8_frames", lambda: comps["f32"](5))):
        jax.block_until_ready(fn_())
        tdir = str(out_dir / f"trace_{name}")
        with jax.profiler.trace(tdir):
            jax.block_until_ready(fn_())
        red = reduce_trace(tdir)
        res[f"trace_{name}"] = red
        print(f"trace {name}: busy {red.get('busy_ms', 0):.3f} ms of span "
              f"{red.get('span_ms', 0):.3f} ms", flush=True)
        for k, v in red.get("lines", {}).items():
            print(f"    line {k}: {v[0]} events, {v[1]:.3f} ms", flush=True)
        for n_, ms, share in red.get("top", []):
            print(f"    {ms:9.4f} ms {share:6.1%}  {n_[:110]}", flush=True)

    (out_dir / "profile.json").write_text(json.dumps(res, indent=1))
    print("wrote", out_dir / "profile.json")


if __name__ == "__main__":
    main()
