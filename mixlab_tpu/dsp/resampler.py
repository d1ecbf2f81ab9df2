"""Polyphase rational resampler (matmul formulation).

The reference has NO resampler — non-44.1 kHz Icecast sources are rejected
with an explicit TODO (``src/icecast/mod.rs:94-97``).  This build adds one
because the benchmark configs run the engine at 48 kHz against 44.1 kHz
sources (BASELINE.json config 3).

Design: classic polyphase L/M rational resampling (windowed-sinc prototype,
Kaiser window), reformulated as a dense matmul so it runs on the matrix units instead
of as a gather-heavy FIR:

  * outputs are grouped L at a time; group ``q`` consumes the input window
    ``x[qM - (J-1) .. qM + M - 1]`` (width W = M+J-1);
  * a dense weight matrix ``W2 [L, W]`` scatters each phase's J taps into its
    window offsets, so a whole block resamples as ``Xwin [G, W] @ W2.T``.

For 44.1k->48k, L/M = 160/147 and W = 147+J-1 — matmul-sized operands.  The
~W/J× redundant MACs are free: the op is bandwidth-bound and the matrix units are idle
otherwise.

Carried state is the last J-1 input samples per channel.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=32)
def design(src_rate: int, dst_rate: int, taps_per_phase: int = 32):
    """Return (L, M, W2) for a src->dst polyphase resampler.

    W2 is the [L, M+J-1] float32 group weight matrix described above.
    """
    g = math.gcd(src_rate, dst_rate)
    L = dst_rate // g
    M = src_rate // g
    J = taps_per_phase
    N = L * J

    # windowed-sinc prototype, cutoff at min(src, dst)/2, gain L in passband
    fc = min(src_rate, dst_rate) / (src_rate * L)  # fraction of upsampled rate
    m = np.arange(N, dtype=np.float64)
    c = (N - 1) / 2.0
    h = L * fc * np.sinc(fc * (m - c)) * np.kaiser(N, beta=9.0)

    W = M + J - 1
    W2 = np.zeros((L, W), dtype=np.float64)
    for r in range(L):
        p = (r * M) % L
        k_off = (r * M) // L  # floor
        for j in range(J):
            w = (J - 1) + k_off - j
            W2[r, w] = h[p + L * j]
    # normalize each polyphase branch to unit DC gain (kills per-phase gain
    # ripple from windowed-sinc truncation)
    W2 /= W2.sum(axis=1, keepdims=True)
    # NOTE: cached as numpy — caching jnp arrays created under a jit trace
    # would leak tracers across traces
    return L, M, W2.astype(np.float32)


def context_len(src_rate: int, dst_rate: int, taps_per_phase: int = 32) -> int:
    return taps_per_phase - 1


def resample_block(x, ctx, src_rate: int, dst_rate: int, taps_per_phase: int = 32):
    """Resample one block.

    ``x``: [S_in, C] (or [S_in]) input at ``src_rate``; S_in must be a
    multiple of M (engine blocks satisfy this: T ticks of 44.1k audio in,
    T ticks of 48k audio out).
    ``ctx``: [J-1, C] carried input history (zeros initially).
    Returns (y [S_in*L/M, C], new_ctx).
    """
    L, M, W2 = design(src_rate, dst_rate, taps_per_phase)
    J = taps_per_phase
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        ctx = ctx[:, None]
    S_in, C = x.shape
    assert S_in % M == 0, f"block of {S_in} input samples not a multiple of {M}"
    G = S_in // M
    W = M + J - 1

    import jax

    xp = jnp.concatenate([ctx, x], axis=0)  # [(J-1)+S_in, C]
    # strided-conv formulation: XLA lowers the overlapping windows natively
    # instead of materializing an im2col gather (the explicit [G, W] gather
    # not chosen: the conv lowers to the same matmuls
    # without the window-copy HBM traffic)
    xr = xp.T[:, None, :]  # [C, 1, (J-1)+S_in]
    y = jax.lax.conv_general_dilated(
        xr,
        jnp.asarray(W2)[:, None, :],  # [L, 1, W]
        window_strides=(M,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,  # full-f32 matmul passes
    )  # [C, L, G]
    y = y.transpose(2, 1, 0).reshape(G * L, C)
    new_ctx = xp[-(J - 1):]
    if squeeze:
        return y[:, 0], new_ctx[:, 0]
    return y, new_ctx


def resample_block_np(x, ctx, src_rate: int, dst_rate: int, taps_per_phase: int = 32):
    """Numpy twin of :func:`resample_block` for host ingest threads (keeps
    network decode paths off the device dispatch queue).  Input length must
    be a multiple of M; pad/carry at the call site."""
    L, M, W2 = design(src_rate, dst_rate, taps_per_phase)
    W2 = np.asarray(W2)
    J = taps_per_phase
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        ctx = ctx[:, None]
    S_in, C = x.shape
    assert S_in % M == 0
    G = S_in // M
    W = M + J - 1
    xp = np.concatenate([ctx, x], axis=0)
    idx = np.arange(G)[:, None] * M + np.arange(W)[None, :]
    y = np.einsum("gwc,lw->glc", xp[idx], W2).reshape(G * L, C).astype(np.float32)
    new_ctx = xp[-(J - 1):]
    if squeeze:
        return y[:, 0], new_ctx[:, 0]
    return y, new_ctx
