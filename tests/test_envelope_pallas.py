"""The envelope's plain-XLA scans (dsp/envelope.py) at the block sizes that
once took a Pallas kernel (>= 32,768 samples), against the sequential
float64 oracle (tests/oracle.py), with state carried across blocks."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import oracle
from mixlab_tpu.dsp.envelope import EnvelopeDef
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import EnvelopeParams

CFG = EngineConfig(sample_rate=48_000)
SPT = CFG.samples_per_tick
# f32 positions and milliseconds against the f64 reference: the relative
# time error grows with the distance to the last edge (a few f32 ulps of
# up to ~10^4 ms), scaled by 1/attack_ms
TOL = 2e-4


def gate_signal(S, seed):
    rng = np.random.default_rng(seed)
    x = np.empty(S, np.float32)
    pos = 0
    while pos < S:
        seg = int(rng.integers(5, 900))
        x[pos : pos + seg] = rng.choice([0.0, 1.0, 0.5], p=[0.35, 0.35, 0.3])
        pos += seg
    return x


def _blocks(params, xs, block):
    """Device outputs and the oracle's over consecutive blocks; the final
    gate mode must agree too."""
    d = EnvelopeDef()
    aux = d.prepare(params, CFG)
    state = d.init_state(params, CFG)
    step = jax.jit(lambda st, x: d.run_block(params, aux, None, st, [x],
                                             CFG, block)[:2])
    ost = None
    got, want = [], []
    for i, x in enumerate(xs):
        state, outs = step(state, jnp.asarray(x))
        got.append(np.asarray(outs[0]))
        o, ost = oracle.envelope(
            i * len(x), x, params.attack_ms, params.decay_ms,
            params.sustain_amplitude, params.release_ms, CFG.sample_rate,
            state=ost)
        want.append(o)
    assert bool(state["mode_on"]) == (ost["mode"] == "on")
    return np.concatenate(got), np.concatenate(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_ticks", [41, 60])
def test_pallas_matches_flat_scans(seed, n_ticks):
    """32,800- and 48,000-sample blocks, three in a row."""
    block = BlockSpec(n_ticks)
    S = block.n_samples(CFG)
    xs = [gate_signal(S, seed * 10 + blk) for blk in range(3)]
    got, want = _blocks(EnvelopeParams(), xs, block)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_pallas_matches_scalar_oracle():
    params = EnvelopeParams(attack_ms=3.0, decay_ms=10.0,
                            sustain_amplitude=0.6, release_ms=25.0)
    block = BlockSpec(480)  # 384,000 samples: the flagship offline block
    S = block.n_samples(CFG)
    got, want = _blocks(params, [gate_signal(S, 7)], block)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_pallas_dense_edges():
    """A gate edge at every sample stresses the edge scans."""
    block = BlockSpec(48)  # 38,400 samples
    S = block.n_samples(CFG)
    rng = np.random.default_rng(3)
    x = rng.choice([0.0, 1.0], size=S).astype(np.float32)
    got, want = _blocks(EnvelopeParams(), [x], block)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_pallas_split_large_blocks():
    """A gate held across block boundaries: the carried on/off positions
    and captured release amplitude continue exactly."""
    block = BlockSpec(41)
    S = block.n_samples(CFG)
    x = np.zeros(3 * S, np.float32)
    x[100:S + 500] = 1.0          # on across the first boundary
    x[2 * S - 50:2 * S + 50] = 1.0  # short gate straddling the second
    got, want = _blocks(EnvelopeParams(), np.split(x, 3), block)
    np.testing.assert_allclose(got, want, atol=TOL)
