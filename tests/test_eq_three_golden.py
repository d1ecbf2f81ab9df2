"""EqThree golden-fixture test.

The reference ships a golden pair (``fixtures/module/eq_three/chronos.f32.raw``
-> ``chronos-eq.f32.raw`` at gains +4/0/+4 dB, produced by its f64 DSP path —
src/module/eq_three.rs:127-168).  The device kernel computes in f32 via
associative scans; tolerance here bounds the f32-vs-f64 and
scan-vs-sequential error over the full 355k-sample fixture.
"""

import numpy as np
import pytest

from conftest import load_f32_raw
from util import run_module
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import Decibel, EqThreeParams

CFG = EngineConfig(sample_rate=44_100)


def test_eq_three_golden_fixture(fixtures_dir):
    x = load_f32_raw(fixtures_dir / "module/eq_three/chronos.f32.raw")
    want = load_f32_raw(fixtures_dir / "module/eq_three/chronos-eq.f32.raw")
    assert x.shape == want.shape

    params = EqThreeParams(Decibel(4.0), Decibel(0.0), Decibel(4.0))

    # run in engine-realistic blocks; last partial tick dropped from compare
    block = BlockSpec(60)
    S = block.n_samples(CFG)
    n_blocks = len(x) // S
    state = None
    outs = []
    for b in range(n_blocks):
        state, (o,), _ = run_module(
            "EqThree", params, [x[b * S : (b + 1) * S]], cfg=CFG, block=block,
            state=state,
        )
        outs.append(o)
    got = np.concatenate(outs)
    want = want[: len(got)]

    err = np.abs(got - want)
    # signal is music at full scale; bound absolute error of the f32 path
    assert err.max() < 5e-4, f"max abs err {err.max()}"
    assert np.sqrt(np.mean(err**2)) < 5e-5, "rms error too large"


def test_eq_three_f64_oracle_matches_fixture_exactly(fixtures_dir):
    """Sanity: our understanding of the algorithm reproduces the fixture in
    f64 (validates the oracle, and transitively the device kernel's spec)."""
    import oracle

    x = load_f32_raw(fixtures_dir / "module/eq_three/chronos.f32.raw")
    want = load_f32_raw(fixtures_dir / "module/eq_three/chronos-eq.f32.raw")
    got = oracle.eq_three_fast(x, 4.0, 0.0, 4.0, 44_100)
    np.testing.assert_allclose(got, want, atol=2e-6)
