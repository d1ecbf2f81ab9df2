"""Crossfade blend kernel.

Reference inner loop: ``src/module/video_mixer.rs:210-235`` — per plane,
``out = (a*fade + b*(255-fade)) / 255`` in u8-load / u16-math / truncating
integer division, 32 pixels per AVX2 iteration.

Device version: the same exact integer semantics, vectorized over whole
planes as plain jnp, which XLA fuses into one memory-bound elementwise
kernel.  The exact ÷255 uses the multiply-shift identity
``x//255 == (x*32897) >> 23`` (valid for 0 <= x <= 65535, verified in tests),
avoiding an integer divide.

It operates on u8 arrays of any [..., H, W] shape, so a batch of frames
(bench mode: one tick per batch row) blends in a single dispatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _div255_u32(x):
    """Exact x // 255 for x in [0, 65535], via multiply-shift on u32."""
    return (x * jnp.uint32(32897)) >> jnp.uint32(23)


def crossfade_xla(a, b, fade):
    """out = (a*fade + b*(255-fade)) // 255, exact u8 semantics.

    ``a``, ``b``: uint8 arrays (same shape); ``fade``: uint8 scalar (0..255).
    """
    fade = jnp.asarray(fade, dtype=jnp.uint32)
    au = a.astype(jnp.uint32)
    bu = b.astype(jnp.uint32)
    acc = au * fade + bu * (jnp.uint32(255) - fade)
    return _div255_u32(acc).astype(jnp.uint8)


def crossfade_picture(a_planes: dict, b_planes: dict, fade: int):
    """Blend all planes of two same-format pictures.

    Eager callers (realtime video tick) get one compiled dispatch for all
    planes; under an enclosing jit the pure path inlines."""
    keys = tuple(sorted(a_planes))
    first = a_planes[keys[0]]
    if isinstance(first, jax.core.Tracer):
        return {
            k: crossfade_xla(a_planes[k], b_planes[k], fade)
            for k in a_planes
        }
    shapes = tuple(a_planes[k].shape for k in keys)
    f = _crossfade_picture_jit(keys, shapes)
    outs = f(tuple(a_planes[k] for k in keys),
             tuple(b_planes[k] for k in keys),
             jnp.uint8(fade))
    return dict(zip(keys, outs))


@functools.lru_cache(maxsize=64)
def _crossfade_picture_jit(keys, shapes):
    def f(a_list, b_list, fade):
        return tuple(
            crossfade_xla(a, b, fade) for a, b in zip(a_list, b_list)
        )

    return jax.jit(f)
