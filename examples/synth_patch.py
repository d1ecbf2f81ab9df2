"""Build a synth patch with the library API and render it offline on the device.

The same graph a user would click together in the browser — trigger ->
envelope -> oscillators -> amplifier -> eq -> monitor — constructed
programmatically and rendered in a single device dispatch (a capability the
reference lacks: it only runs in realtime).

    python examples/synth_patch.py out.wav --seconds 5
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_patch():
    from mixlab_tpu import protocol as p
    from mixlab_tpu.engine.graph import Workspace

    ws = Workspace()

    def add(kind, params):
        return ws.create_module(p.ModuleParams(kind, params))

    trig = add("Trigger", p.GateState.OPEN)
    env = add("Envelope", p.EnvelopeParams(
        attack_ms=40.0, decay_ms=120.0, sustain_amplitude=0.6,
        release_ms=300.0))
    osc1 = add("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW))
    osc2 = add("Oscillator", p.OscillatorParams(220.5, p.Waveform.SAW))
    amp1 = add("Amplifier", p.AmplifierParams(amplitude=0.7, mod_depth=1.0))
    amp2 = add("Amplifier", p.AmplifierParams(amplitude=0.7, mod_depth=1.0))
    mix = add("Mixer", p.MixerParams.with_channels(4))
    split = add("StereoSplitter", None)
    eq = add("EqThree", p.EqThreeParams(
        p.Decibel(3.0), p.Decibel(-1.0), p.Decibel(2.0)))
    pan = add("StereoPanner", None)
    mon = add("Monitor", None)

    ws.connect(p.InputId(env, 0), p.OutputId(trig, 0))     # gate
    # oscillator stereo outs (index 1) through envelope-modulated amps
    ws.connect(p.InputId(amp1, 0), p.OutputId(osc1, 1))
    ws.connect(p.InputId(amp1, 1), p.OutputId(env, 0))
    ws.connect(p.InputId(amp2, 0), p.OutputId(osc2, 1))
    ws.connect(p.InputId(amp2, 1), p.OutputId(env, 0))
    ws.connect(p.InputId(mix, 0), p.OutputId(amp1, 0))
    ws.connect(p.InputId(mix, 1), p.OutputId(amp2, 0))
    # mixer -> split; left leg through the eq, re-paired in the panner
    ws.connect(p.InputId(split, 0), p.OutputId(mix, 0))
    ws.connect(p.InputId(eq, 0), p.OutputId(split, 0))
    ws.connect(p.InputId(pan, 0), p.OutputId(eq, 0))
    ws.connect(p.InputId(pan, 1), p.OutputId(split, 1))
    ws.connect(p.InputId(mon, 1), p.OutputId(pan, 0))      # monitor audio
    return ws, mon


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("output", help="output WAV path")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--sample-rate", type=int, default=48_000)
    args = parser.parse_args(argv)

    import numpy as np

    from mixlab_tpu.engine.config import EngineConfig
    from mixlab_tpu.engine.render import render
    from mixlab_tpu.io_host.wav import write_wav

    cfg = EngineConfig(sample_rate=args.sample_rate)
    ws, mon = build_patch()
    n_ticks = int(args.seconds * cfg.ticks_per_second)
    res = render(ws, n_ticks, cfg)
    audio = np.asarray(res.monitor_audio(mon))
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    write_wav(args.output, cfg.sample_rate, pcm)
    rms = float(np.sqrt((audio.astype(np.float64) ** 2).mean()))
    print(f"wrote {args.output}: {len(pcm)} samples @ {cfg.sample_rate} Hz, "
          f"rms {rms:.3f}")
    assert rms > 0.01, "patch rendered silence"
    return 0


if __name__ == "__main__":
    sys.exit(main())
