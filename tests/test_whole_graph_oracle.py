"""Whole-graph offline render vs a composed float64 oracle.

SURVEY §4: the reference has no whole-graph tests; this build's strategy
is per-kernel goldens plus whole-graph renders against a scalar reference.
This composes the flagship 16-module bench graph in numpy f64 using the
oracle kernels and compares the monitor output sample-for-sample.
"""

import jax
import numpy as np
import pytest

import oracle
from bench import build_16_module_graph
from mixlab_tpu.dsp.base import interleave_tap
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.render import render
from mixlab_tpu.engine.scan_render import build_scanned, stacked_host_aux
from mixlab_tpu.server.fleet_serve import FleetEngine

CFG = EngineConfig(sample_rate=48_000)


def test_flagship_graph_matches_composed_oracle():
    ws, mon = build_16_module_graph()
    n_ticks = 6
    res = render(ws, n_ticks=n_ticks, cfg=CFG, block_ticks=3)
    got = res.monitor_audio(mon)
    S = n_ticks * CFG.samples_per_tick
    want = oracle.flagship_16_module(S, CFG.sample_rate)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-3)
    # and it's non-trivial signal
    assert np.abs(got).max() > 0.5


# The flagship programs the card runs: the offline render in 60- and
# 480-tick blocks (48,000 and 384,000 samples) and the fleet serving step in
# 15-tick blocks; the short blocks run twice so the carried state is checked.
PROGRAMS = [("render", 60), ("render", 480), ("fleet", 15)]


def _program(kind, ticks, n_blocks=None):
    """-> (jitted fn, args, fetch(out) -> monitor audio [S, 2])."""
    ws, mon = build_16_module_graph()
    block = BlockSpec(ticks)
    n_blocks = n_blocks or (1 if ticks == 480 else 2)
    if kind == "render":
        patch, fn = build_scanned(ws, CFG, block)
        args = (patch.prepare_aux(ws), stacked_host_aux(patch, 0, n_blocks),
                patch.init_state(ws))

        def fetch(out):
            return interleave_tap(out[1][str(mon.value)]["audio"]).reshape(-1, 2)

        return fn, args, fetch
    eng = FleetEngine(ws, 2, CFG, block_ticks=ticks)
    S = block.n_samples(CFG)
    mask = np.zeros(2, dtype=bool)

    def run(aux, state):
        outs = []
        for b in range(n_blocks):
            state, taps = eng._step(aux, eng.fleet.host_aux(b * S), state, mask)
            outs.append(taps)
        return outs

    def fetch(outs):
        # session 0's i16 monitor PCM, back to [-1, 1]
        return np.concatenate([
            np.stack([np.asarray(c)[0].reshape(-1) for c in
                      t[str(mon.value)]["audio"]], -1) for t in outs]) / 32767.0

    return run, (eng.fleet.aux, eng.fleet.state), fetch


@pytest.mark.parametrize("kind,ticks", PROGRAMS)
def test_flagship_programs_match_oracle_at_real_blocks(kind, ticks):
    fn, args, fetch = _program(kind, ticks)
    got = fetch(fn(*args))
    want = oracle.flagship_16_module(got.shape[0], CFG.sample_rate)
    # FmSine's f32 modulation phase (documented deviation, dsp/audio.py)
    # drifts with absolute time (~2e-3 at 8 s); i16 PCM adds 1/32767
    atol = 3e-3
    if kind == "fleet":  # the fleet's i16 monitor PCM clips at full scale
        want = np.clip(want, -1.0, 1.0)
        atol += 2 / 32767
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("kind,ticks", PROGRAMS)
def test_flagship_programs_hold_no_pallas_kernel(kind, ticks):
    """No Pallas kernel (and so none in interpret mode) in the programs
    that run on the card."""
    fn, args, _ = _program(kind, ticks, n_blocks=1)
    assert "pallas_call" not in str(jax.make_jaxpr(fn)(*args))
