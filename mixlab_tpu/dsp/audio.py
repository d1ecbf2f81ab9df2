"""Elementwise / reduction audio modules.

Device kernels with the semantics of the reference modules:
  * Oscillator      — src/module/oscillator.rs:25-89
  * FmSine          — src/module/fm_sine.rs:37-55
  * Amplifier       — src/module/amplifier.rs:38-73
  * Mixer           — src/module/mixer.rs:46-71
  * StereoPanner    — src/module/stereo_panner.rs:30-41
  * StereoSplitter  — src/module/stereo_splitter.rs:33-48
  * Trigger         — src/module/trigger.rs:36-49

All are pure elementwise/reduction math over a whole block of ticks, so XLA
fuses the entire chain into a handful of elementwise kernels.  The reference computes
in f64; on the device we compute in f32 with host-side f64 phase bases per tick for
the oscillators (see notes inline) so precision does not degrade with
absolute time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.dsp.base import ModuleDef, expect_mono, expect_stereo
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import (
    AmplifierParams,
    FmSineParams,
    GateState,
    LineType,
    MixerParams,
    OscillatorParams,
    Waveform,
)

# ---------------------------------------------------------------------------
# waveform primitives (oscillator.rs:15-37), period-1 functions of phase n
# ---------------------------------------------------------------------------


def _sine(n):
    return jnp.sin(n * (2.0 * np.pi))


def _square(n):
    # sign(sine(n)) with sign() mapping +0.0->1, -0.0->-1 (is_sign_positive
    # semantics, oscillator.rs:15-23). sin never returns -0 for our inputs in
    # practice; use >=0 -> 1 else -1, with exact-zero -> 1 to match +0 case.
    s = _sine(n)
    return jnp.where(s >= 0.0, 1.0, -1.0)


def _saw(n):
    return 2.0 * (n - jnp.floor(0.5 + n))


def _triangle(n):
    return 2.0 * jnp.abs(_saw(n)) - 1.0


# ---------------------------------------------------------------------------


class OscillatorDef(ModuleDef):
    kind = "Oscillator"

    def terminals(self, params: OscillatorParams):
        return [], [LineType.MONO.labeled("Mono"), LineType.STEREO.labeled("Stereo")]

    def prepare(self, params: OscillatorParams, cfg: EngineConfig):
        # per-sample phase increment; traced so freq slides don't recompile
        return {"delta": jnp.float32(params.freq / cfg.sample_rate)}

    def host_prepare(self, params: OscillatorParams, t0: int, block: BlockSpec, cfg):
        # Reference computes phase n = t*freq/sr in f64 (oscillator.rs:73-77).
        # f32 cannot hold t*freq/sr for large t, so the host computes the
        # fractional phase at each tick start in f64 and the device only adds
        # the small within-tick ramp i*delta (i < samples_per_tick).
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        # (tick*spt) * freq / sr  computed exactly in f64, wrapped mod 1
        base = np.mod(ticks * spt * (params.freq / cfg.sample_rate), 1.0)
        return {"base": jnp.asarray(base, dtype=jnp.float32)}

    def host_prepare_batched(self, params_list, t0: int, block: BlockSpec, cfg):
        """Fleet fast path: one vectorized phase-base compute for N
        instances (parallel/fleet.py) — the per-instance loop measured
        ~1 ms/instance/block, which starves a 60 Hz loop at serving scale."""
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        freqs = np.array([p.freq for p in params_list], dtype=np.float64)
        base = np.mod(ticks[None, :] * spt
                      * (freqs[:, None] / cfg.sample_rate), 1.0)
        return {"base": base.astype(np.float32)}

    def structural_key(self, params: OscillatorParams):
        return params.waveform

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        spt = cfg.samples_per_tick
        waveform = params.waveform
        i = jnp.arange(spt, dtype=jnp.float32)
        # [T, spt] phases
        n = host_aux["base"][:, None] + i[None, :] * aux["delta"]
        n = n.reshape(-1)
        if waveform == Waveform.SINE:
            s = _sine(n)
        elif waveform == Waveform.SQUARE:
            s = _square(n)
        elif waveform == Waveform.SAW:
            s = _saw(n)
        elif waveform == Waveform.TRIANGLE:
            s = _triangle(n)
        elif waveform == Waveform.ON:
            s = jnp.ones_like(n)
        else:  # OFF
            s = jnp.zeros_like(n)
        s = s.astype(jnp.float32)
        # stereo = the SAME traced value on both channels: zero device ops,
        # and downstream consumers of only one channel pay for one
        return state, [s, (s, s)], {}


class FmSineDef(ModuleDef):
    kind = "FmSine"

    def terminals(self, params: FmSineParams):
        return [LineType.MONO.unlabeled()], [LineType.STEREO.unlabeled()]

    def prepare(self, params: FmSineParams, cfg: EngineConfig):
        freq_amp = (params.freq_hi - params.freq_lo) / 2.0
        freq_mid = params.freq_lo + freq_amp
        return {
            "freq_amp": jnp.float32(freq_amp),
            "mid_delta": jnp.float32(freq_mid / cfg.sample_rate),
        }

    def host_prepare(self, params: FmSineParams, t0: int, block: BlockSpec, cfg):
        # n = (f_mid + f_amp*x) * t  (fm_sine.rs:42-50). Split into the
        # carrier term f_mid*t (host f64 per-tick base, exact) and the
        # modulation term f_amp*x*t (device f32; precision degrades with
        # absolute t — documented deviation from the reference's f64; error
        # is < 1e-3 cycles within the first ~10 min of stream time).
        spt = cfg.samples_per_tick
        freq_amp = (params.freq_hi - params.freq_lo) / 2.0
        freq_mid = params.freq_lo + freq_amp
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        tsamp = ticks * spt
        base_mid = np.mod(tsamp * (freq_mid / cfg.sample_rate), 1.0)
        # fractional part of f_amp * t_seconds at tick starts: keeping only
        # the fraction is safe because it multiplies x only after scaling —
        # NOT mathematically identical for non-integer x, so keep the full
        # value in f64 then cast (documented precision limit above).
        tsec = tsamp / cfg.sample_rate
        return {
            "base_mid": jnp.asarray(base_mid, dtype=jnp.float32),
            "tsec": jnp.asarray(tsec, dtype=jnp.float32),
        }

    def host_prepare_batched(self, params_list, t0: int, block: BlockSpec, cfg):
        """Fleet fast path (see OscillatorDef.host_prepare_batched)."""
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        tsamp = ticks * spt
        amps = np.array([(p.freq_hi - p.freq_lo) / 2.0 for p in params_list])
        mids = np.array([p.freq_lo for p in params_list]) + amps
        base_mid = np.mod(tsamp[None, :] * (mids[:, None] / cfg.sample_rate),
                          1.0)
        tsec = np.broadcast_to(tsamp / cfg.sample_rate,
                               (len(params_list), block.n_ticks))
        return {
            "base_mid": base_mid.astype(np.float32),
            "tsec": tsec.astype(np.float32),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        spt = cfg.samples_per_tick
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S).reshape(block.n_ticks, spt)
        i = jnp.arange(spt, dtype=jnp.float32)
        carrier = host_aux["base_mid"][:, None] + i[None, :] * aux["mid_delta"]
        tsec = host_aux["tsec"][:, None] + i[None, :] * jnp.float32(
            1.0 / cfg.sample_rate
        )
        n = carrier + aux["freq_amp"] * x * tsec
        s = jnp.sin(n * (2.0 * np.pi)).astype(jnp.float32).reshape(-1)
        return state, [(s, s)], {}


class AmplifierDef(ModuleDef):
    kind = "Amplifier"

    def terminals(self, params: AmplifierParams):
        return (
            [LineType.STEREO.labeled("Input"), LineType.MONO.labeled("Control")],
            [LineType.STEREO.unlabeled()],
        )

    def prepare(self, params: AmplifierParams, cfg: EngineConfig):
        return {
            "amplitude": jnp.float32(params.amplitude),
            "mod_depth": jnp.float32(params.mod_depth),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[0], S)
        if inputs[1] is None:
            # unconnected control -> mod_value 1.0 -> depth() == 1 exactly
            # (amplifier.rs:43-47,56)
            scale = aux["amplitude"]
        else:
            mod = inputs[1]  # [S] mono, one value per frame (amplifier.rs:55)
            scale = (1.0 - aux["mod_depth"] + aux["mod_depth"] * mod) * aux[
                "amplitude"
            ]
        return state, [((l * scale).astype(jnp.float32),
                        (r * scale).astype(jnp.float32))], {}


class MixerDef(ModuleDef):
    kind = "Mixer"

    def structural_key(self, params: MixerParams):
        return len(params.channels)

    def terminals(self, params: MixerParams):
        ins = [LineType.STEREO.labeled(str(i + 1)) for i in range(len(params.channels))]
        outs = [LineType.STEREO.labeled("Master"), LineType.STEREO.labeled("Cue")]
        return ins, outs

    def prepare(self, params: MixerParams, cfg: EngineConfig):
        # channel_gain = fader * gain.to_linear() computed host-side in f64
        # (mixer.rs:60); cue is a 0/1 mask so toggling cue doesn't recompile
        gains = np.array(
            [c.fader * c.gain.to_linear() for c in params.channels], dtype=np.float32
        )
        cues = np.array([1.0 if c.cue else 0.0 for c in params.channels], dtype=np.float32)
        return {"gains": jnp.asarray(gains), "cues": jnp.asarray(cues)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        C = len(inputs)
        if C == 0:
            z = jnp.zeros((S,), dtype=jnp.float32)
            return state, [(z, z), (z, z)], {}
        chans = [expect_stereo(i, S) for i in inputs]
        g, c = aux["gains"], aux["cues"]

        # weighted per-lane sums as fused fma chains; no [C,S,2] stack
        def mix(w):
            lo = sum(w[k] * ch[0] for k, ch in enumerate(chans))
            ro = sum(w[k] * ch[1] for k, ch in enumerate(chans))
            return (lo.astype(jnp.float32), ro.astype(jnp.float32))

        return state, [mix(g), mix(c)], {}


class StereoPannerDef(ModuleDef):
    kind = "StereoPanner"

    def terminals(self, params):
        return (
            [LineType.MONO.labeled("L"), LineType.MONO.labeled("R")],
            [LineType.STEREO.unlabeled()],
        )

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        left = expect_mono(inputs[0], S)
        right = expect_mono(inputs[1], S)
        return state, [(left, right)], {}  # channel routing = pytree plumbing


class StereoSplitterDef(ModuleDef):
    kind = "StereoSplitter"

    def terminals(self, params):
        return (
            [LineType.STEREO.unlabeled()],
            [LineType.MONO.labeled("L"), LineType.MONO.labeled("R")],
        )

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[0], S)
        return state, [l, r], {}  # zero device ops


class TriggerDef(ModuleDef):
    kind = "Trigger"

    def terminals(self, params: GateState):
        return [], [LineType.MONO.unlabeled()]

    def prepare(self, params: GateState, cfg: EngineConfig):
        return {"value": jnp.float32(1.0 if params == GateState.OPEN else 0.0)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        return state, [jnp.full((S,), aux["value"], dtype=jnp.float32)], {}
