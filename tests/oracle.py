"""Scalar float64 oracle implementations of the reference DSP modules.

These mirror the reference Rust code operation-for-operation (in numpy/f64,
the same precision the reference computes in) and serve as the correctness
baseline for the device kernels.  Each function cites the reference lines it
mirrors.  Deliberately straightforward — clarity over speed.
"""

from __future__ import annotations

import math

import numpy as np


# --- oscillator (src/module/oscillator.rs:15-37,73-89) ---------------------


def oscillator(t0: int, n: int, freq: float, waveform: str, sample_rate: int):
    t = (t0 + np.arange(n, dtype=np.float64)) / sample_rate
    ph = t * freq
    if waveform == "sine":
        s = np.sin(ph * 2.0 * np.pi)
    elif waveform == "square":
        sine = np.sin(ph * 2.0 * np.pi)
        s = np.where(np.signbit(sine), -1.0, 1.0)
    elif waveform == "saw":
        s = 2.0 * (ph - np.floor(0.5 + ph))
    elif waveform == "triangle":
        saw = 2.0 * (ph - np.floor(0.5 + ph))
        s = 2.0 * np.abs(saw) - 1.0
    elif waveform == "on":
        s = np.ones(n)
    else:
        s = np.zeros(n)
    return s.astype(np.float32)


# --- fm_sine (src/module/fm_sine.rs:37-55) ---------------------------------


def fm_sine(t0: int, x_mono: np.ndarray, freq_lo: float, freq_hi: float, sample_rate: int):
    n = len(x_mono)
    freq_amp = (freq_hi - freq_lo) / 2.0
    freq_mid = freq_lo + freq_amp
    t = (t0 + np.arange(n, dtype=np.float64)) / sample_rate
    co = (freq_mid + freq_amp * x_mono.astype(np.float64)) * 2.0 * np.pi
    return np.sin(co * t).astype(np.float32)


# --- amplifier (src/module/amplifier.rs:38-73) -----------------------------


def amplifier(x_stereo: np.ndarray, mod_mono, amplitude: float, mod_depth: float):
    """x_stereo: [S,2] f32; mod_mono: [S] f32 or None."""
    x = x_stereo.astype(np.float64)
    if mod_mono is None:
        depth = 1.0
        out = x * depth * amplitude
    else:
        m = mod_mono.astype(np.float64)
        depth = 1.0 - mod_depth + mod_depth * m
        out = x * (depth * amplitude)[:, None]
    return out.astype(np.float32)


# --- mixer (src/module/mixer.rs:46-71) -------------------------------------


def mixer(inputs, gains_db, faders, cues):
    """inputs: list of [S,2] f32 (or None); returns (master, cue) f32."""
    S = next(len(i) for i in inputs if i is not None)
    master = np.zeros((S, 2), dtype=np.float32)
    cue = np.zeros((S, 2), dtype=np.float32)
    for x, gdb, fader, c in zip(inputs, gains_db, faders, cues):
        if x is None:
            x = np.zeros((S, 2), dtype=np.float32)
        gain = fader * (10.0 ** (gdb / 20.0))
        master += (x.astype(np.float64) * gain).astype(np.float32)
        if c:
            cue += x
    return master, cue


# --- envelope (src/module/envelope.rs) -------------------------------------


def envelope(
    t0: int,
    x: np.ndarray,
    attack_ms: float,
    decay_ms: float,
    sustain: float,
    release_ms: float,
    sample_rate: int,
    state=None,
):
    """Sequential state machine; returns (out f32, state)."""
    if state is None:
        state = {"mode": "initial", "on": 0, "off": 0, "off_amp": 0.0}

    def amp(t):
        if state["mode"] == "initial":
            return 0.0
        if state["mode"] == "on":
            ms_on = (t - state["on"]) / sample_rate * 1000.0
            if ms_on < attack_ms:
                return 1.0 / attack_ms * ms_on
            ms_decay = ms_on - attack_ms
            decay_amp = 1.0 - min(max(1.0 / decay_ms * ms_decay, 0.0), 1.0)
            return sustain + (1.0 - sustain) * decay_amp
        ms_off = (t - state["off"]) / sample_rate * 1000.0
        rel = 1.0 - min(max(1.0 / release_ms * ms_off, 0.0), 1.0)
        return state["off_amp"] * rel

    out = np.zeros(len(x), dtype=np.float32)
    for i, xi in enumerate(x):
        t = t0 + i
        if state["mode"] in ("initial", "off"):
            if xi == 1.0:
                state = {"mode": "on", "on": t, "off": 0, "off_amp": 0.0}
        else:
            if xi == 0.0:
                oa = amp(t)
                state = {"mode": "off", "on": state["on"], "off": t, "off_amp": oa}
        out[i] = amp(t)
    return out, state


# --- eq_three (src/module/eq_three.rs) -------------------------------------

VSA = 1.0 / 4294967295.0


def eq_three(
    x: np.ndarray,
    gain_lo_db: float,
    gain_mid_db: float,
    gain_hi_db: float,
    sample_rate: int,
    state=None,
):
    """Mirrors EqThree::run_tick exactly (f64 math, f32 output)."""
    f_lo = 2.0 * math.sin(math.pi * 420.0 / sample_rate)
    f_hi = 2.0 * math.sin(math.pi * 2700.0 / sample_rate)
    if state is None:
        state = {"lo": [0.0] * 4, "hi": [0.0] * 4, "hist": [0.0] * 3}
    g_lo = 10.0 ** (gain_lo_db / 20.0)
    g_mid = 10.0 ** (gain_mid_db / 20.0)
    g_hi = 10.0 ** (gain_hi_db / 20.0)

    def pump(poles, f, s):
        poles[0] += f * (s - poles[0]) + VSA
        poles[1] += f * (poles[0] - poles[1])
        poles[2] += f * (poles[1] - poles[2])
        poles[3] += f * (poles[2] - poles[3])
        return poles[3]

    out = np.zeros(len(x), dtype=np.float32)
    lo_p, hi_p, hist = state["lo"], state["hi"], state["hist"]
    for i, xi in enumerate(x):
        s = float(xi)
        lo = pump(lo_p, f_lo, s)
        hi = hist[0] - pump(hi_p, f_hi, s)
        mid = hist[0] - (hi + lo)
        hist[0], hist[1], hist[2] = hist[1], hist[2], s
        out[i] = np.float32(lo * g_lo + mid * g_mid + hi * g_hi)
    return out, state


def eq_three_fast(x, gain_lo_db, gain_mid_db, gain_hi_db, sample_rate):
    """Vectorized f64 equivalent using scipy.lfilter (rounding differs from
    the sequential oracle by ~1 ulp/step; used for long fixtures)."""
    from scipy.signal import lfilter

    f_lo = 2.0 * math.sin(math.pi * 420.0 / sample_rate)
    f_hi = 2.0 * math.sin(math.pi * 2700.0 / sample_rate)
    x = x.astype(np.float64)

    def cascade4(f, x):
        y = lfilter([1.0], [1.0, -(1.0 - f)], f * x + VSA)
        for _ in range(3):
            y = lfilter([1.0], [1.0, -(1.0 - f)], f * y)
        return y

    lo = cascade4(f_lo, x)
    hi_lp = cascade4(f_hi, x)
    xd = np.concatenate([np.zeros(3), x])[: len(x)]
    hi = xd - hi_lp
    mid = xd - (hi + lo)
    g_lo = 10.0 ** (gain_lo_db / 20.0)
    g_mid = 10.0 ** (gain_mid_db / 20.0)
    g_hi = 10.0 ** (gain_hi_db / 20.0)
    return (lo * g_lo + mid * g_mid + hi * g_hi).astype(np.float32)


# --- the flagship 16-module graph (bench.py build_16_module_graph) ----------


def flagship_16_module(n_samples: int, sr: int):
    """Monitor output [S, 2] of bench.py's build_16_module_graph, composed
    from the kernels above in f64."""
    # trigger open -> envelope
    gate = np.ones(n_samples, dtype=np.float32)
    env, _ = envelope(0, gate, 25.0, 500.0, 0.8, 200.0, sr)

    # four osc(110*i) -> amplifier(0.5, mod 0.3 by env)
    amps = []
    for i in range(4):
        mono = oscillator(0, n_samples, 110.0 * (i + 1), "sine", sr)
        stereo = np.stack([mono, mono], -1)
        amps.append(amplifier(stereo, env, 0.5, 0.3))

    # fm_sine driven by env
    fm_mono = fm_sine(0, env, 440.0, 880.0, sr)
    fm = np.stack([fm_mono, fm_mono], -1)

    # splitter(amps[0]) -> eq(L) ; panner(eq_L, amp0_R)
    eq_l, _ = eq_three(amps[0][:, 0], 4.0, 0.0, 4.0, sr)
    pan = np.stack([eq_l, amps[0][:, 1]], -1)

    # mixer channels: amps0-3, fm, pan, amps[1], amps[2]; defaults: gain 0dB,
    # fader 1.0, cue off
    inputs = [amps[0], amps[1], amps[2], amps[3], fm, pan, amps[1], amps[2]]
    master, _ = mixer(inputs, [0.0] * 8, [1.0] * 8, [False] * 8)
    return master
