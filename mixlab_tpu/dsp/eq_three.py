"""3-band EQ ("EqThree") as parallel first-order linear-recurrence scans.

Reference: ``src/module/eq_three.rs`` — two 4-pole cascades of identical
one-pole low-passes at 420 Hz / 2700 Hz (``LowPass::pump``,
eq_three.rs:117-124), a 3-sample delay line, and per-band linear gains:

    lo   = LP_lo^4(x)
    hi   = x[i-3] - LP_hi^4(x)
    mid  = x[i-3] - (hi + lo)      (== LP_hi^4(x) - lo)
    out  = lo*g_lo + mid*g_mid + hi*g_hi

Each one-pole stage is ``y_i = (1-f)·y_{i-1} + f·x_i (+ VSA on stage 0)`` — a
first-order linear recurrence, which is an associative operation on (a, b)
pairs under ``(a1,b1)∘(a2,b2) = (a1·a2, a2·b1 + b2)``.  This build runs
the lo and hi filters *together* (stacked on a trailing lane axis) through 4
blocked recurrences — chunked Toeplitz matmuls plus an O(log S) scan over the
chunk carries instead of O(S) sequential steps — and carries the 8 pole
values + 3 history samples as explicit state.

The reference computes in f64 and stores f32; device math here is f32 (the
accelerator has no fast f64).  Golden-fixture tolerance is validated in
``tests/test_eq_three_golden.py`` against ``fixtures/module/eq_three/``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mixlab_tpu.dsp.base import ModuleDef, expect_mono
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.protocol import EqThreeParams, LineType

FREQ_LO = 420.0  # eq_three.rs:8
FREQ_HI = 2700.0  # eq_three.rs:9
VSA = 1.0 / 4294967295.0  # denormal fix (eq_three.rs:11); kept for parity


def _filter_coeff(freq: float, sample_rate: int) -> float:
    # eq_three.rs:113-115
    return 2.0 * math.sin(math.pi * freq / sample_rate)


def _linrec_scan(a_const, b, y_init):
    """Solve y_i = a·y_{i-1} + b_i with y_{-1}=y_init along axis 0.

    ``a_const`` scalar-per-lane [2], ``b`` [S, 2], ``y_init`` [2].
    Returns y [S, 2].
    """
    S = b.shape[0]
    a = jnp.broadcast_to(a_const, b.shape)

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2

    a_pref, b_pref = jax.lax.associative_scan(combine, (a, b))
    return a_pref * y_init + b_pref


_CHUNK = 256  # Toeplitz block size (matmul-friendly, a^C well within f32 range)


@functools.lru_cache(maxsize=8)
def _toeplitz_tables(a_tuple, C):
    """Per-lane lower-triangular Toeplitz T[l,i,j] = a_l^(i-j) (i>=j) and
    powers P[l,i] = a_l^(i+1).  Cached as NUMPY arrays (caching jnp arrays
    created under a jit trace would leak tracers across traces)."""
    a = np.asarray(a_tuple, dtype=np.float64)
    i = np.arange(C)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a[:, None, None] ** np.maximum(expo, 0)[None], 0.0)
    P = a[:, None] ** (i + 1)[None]
    return (
        T.astype(np.float32),
        P.astype(np.float32),
        (a**C).astype(np.float32),
    )


def _linrec_blocked(a_tuple, b, y_init):
    """Same recurrence as :func:`_linrec_scan`, evaluated as chunked Toeplitz
    matmuls: within each length-C chunk the zero-state response is
    ``T @ b`` (one batched matmul), and the cross-chunk carry is a tiny
    first-order recurrence over S/C chunks solved by an associative scan.
    It moves far fewer bytes than the log-depth scan over the whole block.

    ``a_tuple``: python tuple of per-lane coefficients (static);
    ``b`` [S, L], ``y_init`` [L].
    """
    S, L = b.shape
    C = _CHUNK
    if S < 2 * C:
        return _linrec_scan(jnp.asarray(a_tuple, jnp.float32), b, y_init)
    if S % C != 0:
        pad = C - (S % C)
        y = _linrec_blocked(a_tuple, jnp.pad(b, ((0, pad), (0, 0))), y_init)
        return y[:S]
    K = S // C
    T, P, aC = _toeplitz_tables(a_tuple, C)

    b2 = b.reshape(K, C, L)
    # Z[k,i,l] = sum_j T[l,i,j] b2[k,j,l]
    # HIGHEST: at default precision f32 matmuls may take reduced-precision
    # inputs (TF32 on the GPU), which loses digits against the reference's
    # f64 golden fixture; these matmuls are small, so full f32 costs little
    Z = jnp.einsum(
        "lij,kjl->kil",
        T,
        b2,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )

    # carry chain over chunks: ylast[k] = aC * ylast[k-1] + Z[k,-1]
    zlast = Z[:, -1, :]  # [K, L]

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2_ = e2
        return a1 * a2, a2 * b1 + b2_

    aCs = jnp.broadcast_to(aC, zlast.shape)
    a_pref, b_pref = jax.lax.associative_scan(combine, (aCs, zlast))
    ylast = a_pref * y_init + b_pref  # [K, L]: y at the end of chunk k
    ylast_prev = jnp.concatenate([y_init[None, :], ylast[:-1]], axis=0)

    y = Z + P.T[None, :, :] * ylast_prev[:, None, :]
    return y.reshape(S, L)


class EqThreeDef(ModuleDef):
    kind = "EqThree"

    def terminals(self, params: EqThreeParams):
        return [LineType.MONO.unlabeled()], [LineType.MONO.unlabeled()]

    def init_state(self, params, cfg: EngineConfig):
        return {
            # poles[k][filter] for k in 0..4, filter 0 = lo, 1 = hi
            "poles": jnp.zeros((4, 2), dtype=jnp.float32),
            "hist": jnp.zeros((3,), dtype=jnp.float32),
        }

    def prepare(self, params: EqThreeParams, cfg: EngineConfig):
        return {
            "gains": jnp.asarray(
                [
                    params.gain_lo.to_linear(),
                    params.gain_mid.to_linear(),
                    params.gain_hi.to_linear(),
                ],
                dtype=jnp.float32,
            )
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block):
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S)

        f_lo = _filter_coeff(FREQ_LO, cfg.sample_rate)
        f_hi = _filter_coeff(FREQ_HI, cfg.sample_rate)

        # 3-sample delay line (eq_three.rs:71-79)
        xd = jnp.concatenate([state["hist"], x])[:S]
        new_hist = jnp.concatenate([state["hist"], x])[-3:]
        g = aux["gains"]

        f = jnp.asarray([f_lo, f_hi], dtype=jnp.float32)
        a_tuple = (1.0 - f_lo, 1.0 - f_hi)

        # stage 0 input: f*x + VSA (VSA only on the first pole, eq_three.rs:118)
        y = x[:, None] * f[None, :] + jnp.float32(VSA)
        poles = []
        for k in range(4):
            y = _linrec_blocked(a_tuple, y, state["poles"][k])
            poles.append(y[-1])
            if k < 3:
                y = y * f[None, :]  # next stage drive: b = f * prev_output

        lo = y[:, 0]
        hi_lp = y[:, 1]
        hi = xd - hi_lp
        mid = xd - (hi + lo)

        out = (lo * g[0] + mid * g[1] + hi * g[2]).astype(jnp.float32)

        new_state = {
            "poles": jnp.stack(poles, axis=0),
            "hist": new_hist,
        }
        return new_state, [out], {}
