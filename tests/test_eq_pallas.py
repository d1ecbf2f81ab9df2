"""EqThree's plain-XLA cascade (dsp/eq_three.py) at the block sizes that
once took a Pallas kernel (>= 8,192 samples), against the sequential
float64 oracle (tests/oracle.py): equivalence, state continuity across
blocks, vmap batching, and blocks past one chunk-table size."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle
from mixlab_tpu.dsp.registry import get_def
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import Decibel, EqThreeParams

CFG = EngineConfig(sample_rate=48_000)
EQ = get_def("EqThree")
GAINS = (4.0, -2.0, 4.0)
PARAMS = EqThreeParams(*(Decibel(g) for g in GAINS))
AUX = EQ.prepare(PARAMS, CFG)
# f32 device math (HIGHEST-precision Toeplitz matmuls) against the f64
# reference on full-scale noise: a few f32 ulps of a signal of magnitude ~2
TOL = 2e-5


def _run(x, st, block):
    return EQ.run_block(PARAMS, AUX, None, st, [x], CFG, block)


def _oracle_state(st):
    poles = np.asarray(st["poles"], np.float64)
    return {"lo": list(poles[:, 0]), "hi": list(poles[:, 1]),
            "hist": list(np.asarray(st["hist"], np.float64))}


def _oracle(x, st=None):
    out, _ = oracle.eq_three(np.asarray(x), *GAINS, CFG.sample_rate,
                             state=None if st is None else _oracle_state(st))
    return out


@pytest.mark.parametrize("n_ticks", [60, 16, 120])
def test_kernel_matches_xla_path(n_ticks):
    block = BlockSpec(n_ticks)
    S = block.n_samples(CFG)
    rng = np.random.default_rng(n_ticks)
    x = jnp.asarray(rng.uniform(-1, 1, S).astype(np.float32))
    st = {"poles": jnp.asarray(rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32)),
          "hist": jnp.asarray(rng.uniform(-1, 1, 3).astype(np.float32))}
    st_out, (out,), _ = _run(x, st, block)
    assert np.abs(np.asarray(out) - _oracle(x, st)).max() < TOL
    # carried state: the last input samples and the final poles
    np.testing.assert_array_equal(np.asarray(st_out["hist"]),
                                  np.asarray(x)[-3:])
    ost = _oracle_state(st)
    oracle.eq_three(np.asarray(x), *GAINS, CFG.sample_rate, state=ost)
    want_poles = np.stack([ost["lo"], ost["hi"]], axis=1)
    assert np.abs(np.asarray(st_out["poles"]) - want_poles).max() < TOL


def test_kernel_state_continuity():
    """Three consecutive 12,000-sample blocks carry state exactly like one
    sequential run over all of them."""
    block = BlockSpec(15)
    S = block.n_samples(CFG)
    rng = np.random.default_rng(7)
    xs = [jnp.asarray(rng.uniform(-1, 1, S).astype(np.float32))
          for _ in range(3)]
    st = EQ.init_state(PARAMS, CFG)
    outs = []
    for x in xs:
        st, (o,), _ = _run(x, st, block)
        outs.append(np.asarray(o))
    want = _oracle(np.concatenate([np.asarray(x) for x in xs]))
    assert np.abs(np.concatenate(outs) - want).max() < TOL


def test_kernel_under_vmap():
    # config 3 vmaps the eq over stems/channels
    block = BlockSpec(60)
    S = block.n_samples(CFG)
    rng = np.random.default_rng(3)
    xs = jnp.asarray(rng.uniform(-1, 1, (4, S)).astype(np.float32))
    st0 = EQ.init_state(PARAMS, CFG)
    sts = jax.tree.map(lambda a: jnp.broadcast_to(a, (4,) + a.shape), st0)

    def one(x, st):
        st2, (out,), _ = _run(x, st, block)
        return out, st2

    outs, _ = jax.vmap(one)(xs, sts)
    for i in range(4):
        assert np.abs(np.asarray(outs[i]) - _oracle(xs[i])).max() < TOL


def test_kernel_split_large_blocks():
    """A block that is not a whole number of 256-sample Toeplitz chunks
    (64,800) and a 384,000-sample flagship block both match the oracle."""
    rng = np.random.default_rng(5)
    for S in (64_800, 384_000):
        block = BlockSpec(S // CFG.samples_per_tick)
        x = jnp.asarray(rng.uniform(-1, 1, S).astype(np.float32))
        _, (out,), _ = _run(x, EQ.init_state(PARAMS, CFG), block)
        assert np.abs(np.asarray(out) - _oracle(x)).max() < TOL, S
