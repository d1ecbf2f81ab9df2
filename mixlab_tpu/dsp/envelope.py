"""ADSR envelope as associative scans.

Reference: ``src/module/envelope.rs`` — a per-sample, data-dependent state
machine (Initial / TriggerOn{on} / TriggerOff{off, off_amplitude}) driven by
exact comparisons ``input == 1.0`` (gate on) and ``input == 0.0`` (gate off),
with piecewise-linear attack/decay/sustain/release (envelope.rs:34-58,96-117).

A sequential per-sample scan would serialize on the device, so this build
reformulates the whole state machine as O(log S) data-parallel passes:

  * the ON/OFF mode is a set/reset flip-flop — "last gate event wins" is an
    associative combine, so one ``associative_scan`` yields the mode at every
    sample;
  * ``on``/``off`` trigger timestamps are running maxima over edge positions
    (``lax.cummax``);
  * ``off_amplitude`` (the envelope value captured at each falling edge) only
    depends on the preceding rising edge — no recursion — so it's a
    "last-valid value wins" associative scan over (position, value) pairs.

Cross-block state is carried as sample offsets *relative to the block start*
(int32), shifted by S each block and clamped, so no int64 is needed on
device.  Amplitude math follows envelope.rs:34-58 including its div-by-zero
behaviour (attack_ms == 0 jumps straight to the decay branch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mixlab_tpu.dsp.base import ModuleDef, expect_mono
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import EnvelopeParams, LineType

# carried positions are clamped at this floor; the "never happened" sentinel
# is strictly below it so a real carried event always wins over the sentinel
_POS_FLOOR = -(2**30)
_SENTINEL = -(2**31) + 1

# The chunked two-pass implementation (envelope_chunked.py) is an
# alternative plain-XLA formulation of the same state machine; it is off
# (the flat scans below run at every block size) until a measurement on the
# card shows it faster.
CHUNKED_THRESHOLD = float("inf")


def _amp_on(ms_since_on, aux):
    """Amplitude in TriggerOn state (envelope.rs:37-51)."""
    attack = aux["attack_ms"]
    decay = aux["decay_ms"]
    sustain = aux["sustain_amplitude"]
    attack_amp = ms_since_on / attack
    ms_decay = ms_since_on - attack
    decay_amp = 1.0 - jnp.clip(ms_decay / decay, 0.0, 1.0)
    sustain_amp = sustain + (1.0 - sustain) * decay_amp
    return jnp.where(ms_since_on < attack, attack_amp, sustain_amp)


class EnvelopeDef(ModuleDef):
    kind = "Envelope"

    def terminals(self, params: EnvelopeParams):
        return [LineType.MONO.unlabeled()], [LineType.MONO.unlabeled()]

    def init_state(self, params, cfg: EngineConfig):
        return {
            "mode_on": jnp.asarray(False),
            "on_pos": jnp.int32(_POS_FLOOR),
            "off_pos": jnp.int32(_POS_FLOOR),
            "off_amp": jnp.float32(0.0),
        }

    def prepare(self, params: EnvelopeParams, cfg: EngineConfig):
        return {
            "attack_ms": jnp.float32(params.attack_ms),
            "decay_ms": jnp.float32(params.decay_ms),
            "sustain_amplitude": jnp.float32(params.sustain_amplitude),
            "release_ms": jnp.float32(params.release_ms),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S)
        ms_per_sample = 1000.0 / cfg.sample_rate

        if S >= CHUNKED_THRESHOLD:
            # chunked two-pass evaluation in plain XLA (see envelope_chunked.py)
            from mixlab_tpu.dsp.envelope_chunked import run_block_chunked

            out, new_state = run_block_chunked(x, state, aux, ms_per_sample)
            return new_state, [out], {}

        idx = jnp.arange(S, dtype=jnp.int32)
        u_set = x == 1.0
        u_rst = x == 0.0

        # --- mode: last gate event wins (set/reset flip-flop) -------------
        has_ev = u_set | u_rst

        def last_wins(a, b):
            ha, va = a
            hb, vb = b
            return ha | hb, jnp.where(hb, vb, va)

        has_pref, mode_scan = jax.lax.associative_scan(last_wins, (has_ev, u_set))
        mode_after = jnp.where(has_pref, mode_scan, state["mode_on"])
        mode_before = jnp.concatenate(
            [state["mode_on"][None], mode_after[:-1]], axis=0
        )

        # --- edges and their positions ------------------------------------
        rising = u_set & ~mode_before
        falling = u_rst & mode_before

        on_scan = jax.lax.cummax(jnp.where(rising, idx, jnp.int32(_SENTINEL)))
        on_pos = jnp.maximum(on_scan, state["on_pos"])

        # off_amplitude candidate at every sample: the envelope value the ON
        # state would have here (only consumed at falling edges; at a falling
        # edge there is no rising edge, so on_pos is the pre-transition one)
        ms_on = (idx - on_pos).astype(jnp.float32) * ms_per_sample
        cand = _amp_on(ms_on, aux)

        off_p = jnp.where(falling, idx, jnp.int32(_SENTINEL))
        off_v = jnp.where(falling, cand, 0.0)

        def last_pos_wins(a, b):
            pa, va = a
            pb, vb = b
            take_b = pb >= pa
            return jnp.where(take_b, pb, pa), jnp.where(take_b, vb, va)

        off_scan_p, off_scan_v = jax.lax.associative_scan(
            last_pos_wins, (off_p, off_v)
        )
        in_block_off = off_scan_p >= 0
        off_pos = jnp.where(in_block_off, off_scan_p, state["off_pos"])
        off_amp = jnp.where(in_block_off, off_scan_v, state["off_amp"])

        # --- output (envelope.rs:34-58, evaluated post-transition) --------
        ms_off = (idx - off_pos).astype(jnp.float32) * ms_per_sample
        release_amp = 1.0 - jnp.clip(ms_off / aux["release_ms"], 0.0, 1.0)
        out = jnp.where(mode_after, _amp_on(ms_on, aux), off_amp * release_amp)
        out = out.astype(jnp.float32)

        new_state = {
            "mode_on": mode_after[-1],
            "on_pos": jnp.maximum(on_pos[-1] - S, _POS_FLOOR).astype(jnp.int32),
            "off_pos": jnp.maximum(off_pos[-1] - S, _POS_FLOOR).astype(jnp.int32),
            "off_amp": off_amp[-1],
        }
        return new_state, [out], {}
