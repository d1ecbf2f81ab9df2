"""Chunked two-pass ADSR envelope.

The flat formulation (dsp/envelope.py) costs several log-depth scans over
the whole block.  This module reformulates the state machine as:

  pass A: split the block into K parallel chunks of C samples; each chunk
          runs the *sequential* state machine across all K lanes at once
          (one [K]-wide vector op per sample step), tracking a symbolic
          summary for BOTH possible entry modes (ON/OFF).  Entry-dependent
          quantities stay symbolic: `on`/`off` may refer to the entry
          values, and a captured `off_amp` may be "ampOn(pos - entry.on)".
  combine: chunk summaries compose associatively (function composition on
          the 2-entry-mode record), so a tiny associative scan over [K]
          resolves every chunk's concrete entry state.
  pass B: re-run the concrete state machine per chunk (again [K]-wide)
          emitting outputs.

Total memory traffic ~2 passes over the signal instead of ~19, at the price
of C sequential steps of [K]-wide vector work.  Both passes run as
``lax.scan``.  Semantics identical to dsp/envelope.py (envelope.rs).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_POS_FLOOR = -(2**30)

# amp record kinds
_AMP_CONCRETE = 0
_AMP_ENTRY = 1  # off_amp = entry.off_amp
_AMP_FROM_ENTRY_ON = 2  # off_amp = ampOn(amp_pos - entry.on)


def _amp_on(ms_since_on, params):
    attack, decay, sustain = params["attack_ms"], params["decay_ms"], params["sustain_amplitude"]
    attack_amp = ms_since_on / attack
    decay_amp = 1.0 - jnp.clip((ms_since_on - attack) / decay, 0.0, 1.0)
    sustain_amp = sustain + (1.0 - sustain) * decay_amp
    return jnp.where(ms_since_on < attack, attack_amp, sustain_amp)


def _amp_on_at(pos, on, params, ms_per_sample):
    return _amp_on((pos - on).astype(jnp.float32) * ms_per_sample, params)


# ---------------------------------------------------------------------------
# pass A: symbolic dual-entry summaries
# ---------------------------------------------------------------------------

_REC_FIELDS = ("mode", "on_sym", "on_pos", "off_sym", "off_pos",
               "amp_kind", "amp_val", "amp_pos")


def _init_record(entry_on: bool, K: int):
    return {
        "mode": jnp.full((K,), entry_on, dtype=jnp.bool_),
        "on_sym": jnp.ones((K,), dtype=jnp.bool_),
        "on_pos": jnp.zeros((K,), dtype=jnp.int32),
        "off_sym": jnp.ones((K,), dtype=jnp.bool_),
        "off_pos": jnp.zeros((K,), dtype=jnp.int32),
        "amp_kind": jnp.full((K,), _AMP_ENTRY, dtype=jnp.int32),
        "amp_val": jnp.zeros((K,), dtype=jnp.float32),
        "amp_pos": jnp.zeros((K,), dtype=jnp.int32),
    }


def _step_symbolic(rec, x, t, params, ms_per_sample):
    """One state-machine step on a [K]-wide symbolic record.

    ``x`` [K] gate samples, ``t`` [K] global positions."""
    rising = (~rec["mode"]) & (x == 1.0)
    falling = rec["mode"] & (x == 0.0)

    # captured off_amp on falling: concrete if `on` is concrete
    conc_amp = _amp_on_at(t, rec["on_pos"], params, ms_per_sample)
    fall_conc = falling & ~rec["on_sym"]
    fall_sym = falling & rec["on_sym"]

    return {
        "mode": jnp.where(rising, True, jnp.where(falling, False, rec["mode"])),
        "on_sym": jnp.where(rising, False, rec["on_sym"]),
        "on_pos": jnp.where(rising, t, rec["on_pos"]),
        "off_sym": jnp.where(falling, False, rec["off_sym"]),
        "off_pos": jnp.where(falling, t, rec["off_pos"]),
        "amp_kind": jnp.where(
            fall_conc, _AMP_CONCRETE, jnp.where(fall_sym, _AMP_FROM_ENTRY_ON, rec["amp_kind"])
        ),
        "amp_val": jnp.where(fall_conc, conc_amp, rec["amp_val"]),
        "amp_pos": jnp.where(fall_sym, t, rec["amp_pos"]),
    }


def _select_machine(pair, mode):
    """pair: dict field -> [2, K] (machine 0 = entry OFF, 1 = entry ON);
    mode: [K] bool selecting per lane."""
    sel = mode.astype(jnp.int32)
    return {f: jnp.take_along_axis(pair[f], sel[None, :], axis=0)[0] for f in _REC_FIELDS}


def _substitute(g, f_exit, params, ms_per_sample):
    """Compose: g's entry symbols replaced by f_exit's (possibly symbolic)
    record.  Returns g∘f as a record with symbols w.r.t. f's entry."""
    out = {}
    out["mode"] = g["mode"]
    out["on_sym"] = jnp.where(g["on_sym"], f_exit["on_sym"], False)
    out["on_pos"] = jnp.where(g["on_sym"], f_exit["on_pos"], g["on_pos"])
    out["off_sym"] = jnp.where(g["off_sym"], f_exit["off_sym"], False)
    out["off_pos"] = jnp.where(g["off_sym"], f_exit["off_pos"], g["off_pos"])

    # amp: kind0 concrete | kind1 -> f's amp record | kind2 -> ampOn(pos - f.on)
    g_k0 = g["amp_kind"] == _AMP_CONCRETE
    g_k1 = g["amp_kind"] == _AMP_ENTRY
    g_k2 = g["amp_kind"] == _AMP_FROM_ENTRY_ON

    # kind2 resolution against f's on record
    k2_conc = g_k2 & ~f_exit["on_sym"]
    k2_val = _amp_on_at(g["amp_pos"], f_exit["on_pos"], params, ms_per_sample)

    out["amp_kind"] = jnp.where(
        g_k0, _AMP_CONCRETE,
        jnp.where(
            g_k1, f_exit["amp_kind"],
            jnp.where(k2_conc, _AMP_CONCRETE, _AMP_FROM_ENTRY_ON),
        ),
    )
    out["amp_val"] = jnp.where(
        g_k0, g["amp_val"],
        jnp.where(g_k1, f_exit["amp_val"], jnp.where(k2_conc, k2_val, 0.0)),
    )
    out["amp_pos"] = jnp.where(g_k1, f_exit["amp_pos"], g["amp_pos"])
    return out


def _compose_pairs(f_pair, g_pair, params, ms_per_sample):
    """Associative combine of chunk transfer functions (per entry mode)."""
    out = {f: [] for f in _REC_FIELDS}
    for m in range(2):
        f_exit = {fld: f_pair[fld][m] for fld in _REC_FIELDS}
        g_sel = _select_machine(g_pair, f_exit["mode"])
        comp = _substitute(g_sel, f_exit, params, ms_per_sample)
        for fld in _REC_FIELDS:
            out[fld].append(comp[fld])
    return {f: jnp.stack(v, axis=0) for f, v in out.items()}


def _apply_to_entry(pair, entry, params, ms_per_sample):
    """Resolve a (possibly composed) chunk record against a concrete entry
    state dict {mode [K]bool, on [K]i32, off [K]i32, amp [K]f32}."""
    rec = _select_machine(pair, entry["mode"])
    on = jnp.where(rec["on_sym"], entry["on"], rec["on_pos"])
    off = jnp.where(rec["off_sym"], entry["off"], rec["off_pos"])
    amp = jnp.where(
        rec["amp_kind"] == _AMP_CONCRETE,
        rec["amp_val"],
        jnp.where(
            rec["amp_kind"] == _AMP_ENTRY,
            entry["amp"],
            _amp_on_at(rec["amp_pos"], entry["on"], params, ms_per_sample),
        ),
    )
    return {"mode": rec["mode"], "on": on, "off": off, "amp": amp}


# ---------------------------------------------------------------------------
# pass B: concrete outputs
# ---------------------------------------------------------------------------


def _step_concrete(st, x, t, params, ms_per_sample):
    """Concrete machine step + output ([K]-wide)."""
    rising = (~st["mode"]) & (x == 1.0)
    falling = st["mode"] & (x == 0.0)
    amp_now = _amp_on_at(t, st["on"], params, ms_per_sample)

    new = {
        "mode": jnp.where(rising, True, jnp.where(falling, False, st["mode"])),
        "on": jnp.where(rising, t, st["on"]),
        "off": jnp.where(falling, t, st["off"]),
        "amp": jnp.where(falling, amp_now, st["amp"]),
    }
    ms_off = (t - new["off"]).astype(jnp.float32) * ms_per_sample
    release = 1.0 - jnp.clip(ms_off / params["release_ms"], 0.0, 1.0)
    on_amp = _amp_on_at(t, new["on"], params, ms_per_sample)
    out = jnp.where(new["mode"], on_amp, new["amp"] * release)
    return new, out.astype(jnp.float32)


# ---------------------------------------------------------------------------
# full block evaluation (lax.scan passes)
# ---------------------------------------------------------------------------


def _lane_positions(C: int, K: int):
    # position of sample (c, k) = k*C + c
    k_idx = jnp.arange(K, dtype=jnp.int32)[None, :] * C
    c_idx = jnp.arange(C, dtype=jnp.int32)[:, None]
    return k_idx + c_idx  # [C, K]


def pick_lanes(S: int) -> int:
    """Lane count: about 190 sequential steps per chunk, trading scan
    length against the width of the [2,K] step vectors and the K-lane
    combine (not tuned on the GPU)."""
    K = max(256, min(4096, S // 192))
    return ((K + 127) // 128) * 128


def run_block_chunked(x, state, params, ms_per_sample, K: int = None,
                      pass_impl: str = "scan"):
    """Evaluate the envelope over ``x`` [S] with carry ``state`` (same dict
    as dsp/envelope.py: mode_on, on_pos, off_pos, off_amp — positions
    relative to block start).  Returns (out [S], new_state)."""
    S = x.shape[0]
    if K is None:
        K = pick_lanes(S)
    C = -(-S // K)  # ceil
    pad = C * K - S
    # 0.5 padding: neither gate-on nor gate-off — state-preserving
    xp = jnp.concatenate([x, jnp.full((pad,), 0.5, x.dtype)]) if pad else x
    xT = xp.reshape(K, C).T  # [C, K]
    tT = _lane_positions(C, K)

    # ---- pass A: dual-machine symbolic summaries per lane ----------------
    init = {
        f: jnp.stack([_init_record(False, K)[f], _init_record(True, K)[f]])
        for f in _REC_FIELDS
    }

    def stepA(rec_pair, inputs):
        xc, tc = inputs
        new = {}
        for m in range(2):
            rec = {f: rec_pair[f][m] for f in _REC_FIELDS}
            stepped = _step_symbolic(rec, xc, tc, params, ms_per_sample)
            for f in _REC_FIELDS:
                new.setdefault(f, []).append(stepped[f])
        return {f: jnp.stack(v) for f, v in new.items()}, None

    summaries, _ = jax.lax.scan(stepA, init, (xT, tT))

    # ---- combine: associative scan over lanes -----------------------------
    # summaries are whole-chunk transfer functions per lane: field -> [2, K].
    # Reorder to leading K for the scan.
    per_lane = {f: jnp.moveaxis(summaries[f], -1, 0) for f in _REC_FIELDS}  # [K, 2]

    def comb(a, b):
        # a, b: field -> [..., 2]; combine elementwise over batch dims
        a2 = {f: jnp.moveaxis(a[f], -1, 0) for f in _REC_FIELDS}  # [2, ...]
        b2 = {f: jnp.moveaxis(b[f], -1, 0) for f in _REC_FIELDS}
        c2 = _compose_pairs(a2, b2, params, ms_per_sample)
        return {f: jnp.moveaxis(c2[f], 0, -1) for f in _REC_FIELDS}

    prefix = jax.lax.associative_scan(comb, per_lane)  # inclusive, [K, 2]

    # entry state per lane: E0 for lane 0; apply(prefix[k-1], E0) for k>0
    E0 = {
        "mode": jnp.broadcast_to(state["mode_on"], (K,)),
        "on": jnp.broadcast_to(state["on_pos"], (K,)).astype(jnp.int32),
        "off": jnp.broadcast_to(state["off_pos"], (K,)).astype(jnp.int32),
        "amp": jnp.broadcast_to(state["off_amp"], (K,)),
    }
    pref_pair = {f: jnp.moveaxis(prefix[f], -1, 0) for f in _REC_FIELDS}  # [2, K]
    applied = _apply_to_entry(pref_pair, E0, params, ms_per_sample)  # exit of lane k
    entries = {
        kf: jnp.concatenate([E0[kf][:1], applied[kf][:-1]])
        for kf in ("mode", "on", "off", "amp")
    }

    # ---- pass B: concrete outputs -----------------------------------------
    def stepB(st, inputs):
        xc, tc = inputs
        st, out = _step_concrete(st, xc, tc, params, ms_per_sample)
        return st, out

    _, outT = jax.lax.scan(stepB, entries, (xT, tT))  # outT [C, K]
    out = outT.T.reshape(-1)[:S]

    exit_state = {kf: applied[kf][-1] for kf in ("mode", "on", "off", "amp")}
    new_state = {
        "mode_on": exit_state["mode"],
        "on_pos": jnp.maximum(exit_state["on"] - S, _POS_FLOOR).astype(jnp.int32),
        "off_pos": jnp.maximum(exit_state["off"] - S, _POS_FLOOR).astype(jnp.int32),
        "off_amp": exit_state["amp"],
    }
    return out, new_state
