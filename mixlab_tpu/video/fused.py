"""Fused composite operators: algebraic folding of linear video stages.

The config5 pipeline runs rgb->yuv, bicubic resize, row-roll and
crossfade as SEPARATE passes over the 1080p planes; each stage is
memory-bound, and the roll and crossfade alone re-read and re-write the
2 MB luma plane.

The fix is not a hand-written mega-kernel but algebra: the row-roll is a
cyclic permutation matrix R, the crossfade is a scalar convex combination,
and the resize is a matrix product — all LINEAR in the source plane.  So

    crossfade(resize(x), roll(resize(x), 1), fade)
      = (fade * (Wh @ x @ Ww) + (255-fade) * (R @ Wh @ x @ Ww)) / 255
      = ((fade * Wh + (255-fade) * roll(Wh, 1, axis=0)) / 255) @ x @ Ww

i.e. ONE resize through a pre-blended row matrix — the roll and crossfade
cost zero additional memory traffic and zero additional FLOPs.  The folded
matrix rides the same matmul routes as the plain resize (video/scale.py).

Semantics note (documented deviation, bounded in tests): the exact
pipeline clips+rounds the resized plane to u8 BEFORE the integer
crossfade (src/module/video_mixer.rs:210-235 semantics); folding blends
the unclipped, unrounded values and clips+rounds once at the end.  At
pixels where the bicubic resize does NOT overshoot [0, 255] the
difference is at most ~1 LSB (deferred rounding, plus the resize tier's
own envelope).  At overshoot pixels the clip nonlinearity does not
commute with the blend, and the fused result can differ by up to the
overshoot magnitude — invisible on legally-exposed video (overshoot
needs near-saturated high-frequency content) but numerically real, which
is why the engine's exact-u8 blend (video/blend.py) remains the module
path and this operator serves the throughput composite pipelines.

XLA already fuses the separate roll/crossfade/sum stages into the resize
consumers, so the fold is expected to save little; it is not measured on
the GPU.  The operator is retained for its algebraic value (single-matrix
form of the composite) with the exact-semantics separate path remaining
the default (bench.py config5 selects it with MIXLAB_BENCH_FUSED=1).

Reference: the SIMD crossfade inner loop it supersedes is
``src/module/video_mixer.rs:210-235``; the compositing pipeline shape is
``src/video/encode.rs:310-398``.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.video.scale import (
    RESIZE_ROUTE,
    _resize_matrix_i8_from,
    resize_matrix,
)


@functools.lru_cache(maxsize=64)
def _blended_row_matrix(in_h: int, out_h: int, fade: int) -> np.ndarray:
    Wh = resize_matrix(in_h, out_h).astype(np.float64)
    f = fade / 255.0
    Wb = f * Wh + (1.0 - f) * np.roll(Wh, 1, axis=0)
    return Wb.astype(np.float32)


def resize_crossfade_roll(plane, out_h: int, out_w: int, fade: int,
                          method: str = "auto"):
    """resize + roll(1 row) + crossfade(fade) in ONE pass.

    Equivalent (within the tolerance documented above) to::

        y = resize_plane(plane, out_h, out_w)
        out = crossfade_xla(y, jnp.roll(y, 1, axis=0), fade)

    ``fade``: int 0..255 (static — it is folded into the weights).
    """
    fade = int(fade)
    if not 0 <= fade <= 255:
        raise ValueError(f"fade out of range: {fade}")
    in_h, in_w = plane.shape
    Wb = _blended_row_matrix(in_h, out_h, fade)
    if method == "auto":
        method = RESIZE_ROUTE
    if method == "int8":
        return _resize_int8_with_rows(plane, Wb, out_w)
    x = plane.astype(jnp.float32)
    x = jnp.einsum("oi,iw->ow", jnp.asarray(Wb), x,
                   preferred_element_type=jnp.float32)
    if in_w != out_w:
        Ww = jnp.asarray(resize_matrix(in_w, out_w))
        x = jnp.einsum("hw,ow->ho", x, Ww, preferred_element_type=jnp.float32)
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


def _resize_int8_with_rows(plane, W_rows: np.ndarray, out_w: int):
    """The s8 two-pass resize of video/scale.py with a caller-supplied
    (pre-blended) row matrix."""
    in_h, in_w = plane.shape
    out_h = W_rows.shape[0]
    xc = (plane.astype(jnp.int16) - 128).astype(jnp.int8)
    Wq, dq, off, bound = _resize_matrix_i8_from(W_rows)
    acc = jnp.einsum("oi,iw->ow", jnp.asarray(Wq), xc,
                     preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * dq[:, None] + (off[:, None] - 128.0)
    if in_w == out_w:
        return jnp.clip(jnp.round(y) + 128.0, 0, 255).astype(jnp.uint8)
    mid_scale = 127.0 / bound
    xc2 = jnp.clip(jnp.round(y * mid_scale), -127, 127).astype(jnp.int8)
    from mixlab_tpu.video.scale import _resize_matrix_i8

    Wq2, dq2, off2, _ = _resize_matrix_i8(in_w, out_w)
    acc2 = jnp.einsum("hw,ow->ho", xc2, jnp.asarray(Wq2),
                      preferred_element_type=jnp.int32)
    y2 = acc2.astype(jnp.float32) * (dq2[None, :] / mid_scale) + off2[None, :]
    return jnp.clip(jnp.round(y2), 0, 255).astype(jnp.uint8)
