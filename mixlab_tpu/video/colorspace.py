"""RGB <-> YUV420p colorspace kernels (BT.601 limited range).

The reference keeps everything yuv420p on the hot path and defers RGB
support with a TODO (``src/module/video_mixer.rs:280``); this build
implements both directions so test-pattern sources and future RGB ingest
compose natively (BASELINE config 4 requires RGB->YUV420).

Math: ITU-R BT.601 "studio swing":
    Y = 16 + 65.481 R' + 128.553 G' + 24.966 B'   (R',G',B' in [0,1])
    U = 128 - 37.797 R' - 74.203 G' + 112.0  B'
    V = 128 + 112.0  R' - 93.786 G' - 18.214 B'
Chroma is 2x2 box-averaged for 4:2:0 (matching the common swscale default),
computed in f32 and rounded to u8.  All ops are fusable elementwise +
reshape-mean; the 3x3 matrix contraction maps to the matrix units for batched frames.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.video.frame import RGB24, YUV420P, Picture, PictureSettings

_RGB2YUV = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float32,
) / 255.0  # applied to 0..255 RGB directly

_YUV2RGB = np.linalg.inv(_RGB2YUV).astype(np.float32)

_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float32)


def rgb_to_yuv420(rgb):
    """[H, W, 3] u8 -> (y [H,W], u [H/2,W/2], v [H/2,W/2]) u8.

    H and W must be even (yuv420 chroma alignment).  Written as explicit
    per-channel linear combinations (fused elementwise) rather than an
    einsum — a K=3 contraction would waste the matrix units and block fusion."""
    H, W, _ = rgb.shape
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    M = _RGB2YUV
    y = M[0, 0] * r + M[0, 1] * g + M[0, 2] * b + _OFFSET[0]
    u = M[1, 0] * r + M[1, 1] * g + M[1, 2] * b + _OFFSET[1]
    v = M[2, 0] * r + M[2, 1] * g + M[2, 2] * b + _OFFSET[2]
    # 2x2 box average chroma
    u = u.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    v = v.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))

    def q(p):
        return jnp.clip(jnp.round(p), 0, 255).astype(jnp.uint8)

    return q(y), q(u), q(v)


def rgb_planes_to_yuv420(r, g, b):
    """Channel-major RGB -> YUV420: three u8 planes in, planes out.

    Same math as :func:`rgb_to_yuv420` (identical results,
    tests/test_video.py), minus the interleaved [H, W, 3] layout in the
    dataflow.  Pattern sources generate planes natively, so sources that
    have planes should pass them here rather than stacking.  XLA already
    fuses the channel slices into the converter, so this entry point is a
    layout convenience, not a perf claim (not measured on the GPU)."""
    H, W = r.shape
    rf = r.astype(jnp.float32)
    gf = g.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    M = _RGB2YUV
    y = M[0, 0] * rf + M[0, 1] * gf + M[0, 2] * bf + _OFFSET[0]
    u = M[1, 0] * rf + M[1, 1] * gf + M[1, 2] * bf + _OFFSET[1]
    v = M[2, 0] * rf + M[2, 1] * gf + M[2, 2] * bf + _OFFSET[2]
    u = u.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    v = v.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))

    def q(p):
        return jnp.clip(jnp.round(p), 0, 255).astype(jnp.uint8)

    return q(y), q(u), q(v)


def _box2_u8(p):
    """Exact 2x2 box SUM of a u8 plane -> u16 [H/2, W/2], no strided slices.

    The obvious formulations need a strided access on the minor
    dimension: a ``[H//2, 2, W//2, 2]`` reshape (or any ``[:, 0::2]``
    slice) is a stride-2 gather.  Instead, reinterpret each adjacent byte
    PAIR as one u16 lane (a pure bitcast: the device and x86 are
    little-endian, so lo byte = even column), split with
    ``& 255`` / ``>> 8`` — full-width vector ops — and pair rows on the
    sublane dimension where reshape-sum is cheap."""
    import jax.lax as lax

    H, W = p.shape
    x16 = lax.bitcast_convert_type(p.reshape(H, W // 2, 2), jnp.uint16)
    cols = (x16 & jnp.uint16(255)) + (x16 >> jnp.uint16(8))  # <= 510
    return cols.reshape(H // 2, 2, W // 2).sum(axis=1, dtype=jnp.uint16)


def rgb_planes_to_yuv420_downfirst(r, g, b):
    """Channel-major RGB -> YUV420 with the chroma matrix applied AFTER an
    exact integer 2x2 downsample (linear maps commute; the f32 evaluation
    order differs from :func:`rgb_to_yuv420` by at most 1 u8 LSB on
    round-to-nearest ties — bound asserted in tests/test_video.py).

    Why: the default path evaluates the chroma matrix at FULL resolution
    and then box-means in f32 with a lane-strided reshape; this one does
    3x fewer chroma-matrix FLOPs and replaces the strided mean with the
    bitcast pairing of :func:`_box2_u8`."""
    rf = r.astype(jnp.float32)
    gf = g.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    M = _RGB2YUV
    y = M[0, 0] * rf + M[0, 1] * gf + M[0, 2] * bf + _OFFSET[0]
    rd = _box2_u8(r).astype(jnp.float32) * 0.25
    gd = _box2_u8(g).astype(jnp.float32) * 0.25
    bd = _box2_u8(b).astype(jnp.float32) * 0.25
    u = M[1, 0] * rd + M[1, 1] * gd + M[1, 2] * bd + _OFFSET[1]
    v = M[2, 0] * rd + M[2, 1] * gd + M[2, 2] * bd + _OFFSET[2]

    def q(p):
        return jnp.clip(jnp.round(p), 0, 255).astype(jnp.uint8)

    return q(y), q(u), q(v)


def yuv420_to_rgb(y, u, v):
    """(y, u, v) u8 planes -> [H, W, 3] u8; chroma nearest-upsampled 2x."""
    H, W = y.shape
    yf = y.astype(jnp.float32) - _OFFSET[0]
    uf = jnp.repeat(jnp.repeat(u.astype(jnp.float32), 2, axis=0), 2, axis=1)[:H, :W] - _OFFSET[1]
    vf = jnp.repeat(jnp.repeat(v.astype(jnp.float32), 2, axis=0), 2, axis=1)[:H, :W] - _OFFSET[2]
    M = _YUV2RGB
    r = M[0, 0] * yf + M[0, 1] * uf + M[0, 2] * vf
    g = M[1, 0] * yf + M[1, 1] * uf + M[1, 2] * vf
    b = M[2, 0] * yf + M[2, 1] * uf + M[2, 2] * vf
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


def picture_rgb_to_yuv420(pic: Picture) -> Picture:
    assert pic.settings.pixel_format == RGB24
    y, u, v = rgb_to_yuv420(pic.planes["rgb"])
    return Picture(
        PictureSettings(pic.settings.width, pic.settings.height, YUV420P),
        {"y": y, "u": u, "v": v},
    )


def picture_yuv420_to_rgb(pic: Picture) -> Picture:
    assert pic.settings.pixel_format == YUV420P
    rgb = yuv420_to_rgb(pic.planes["y"], pic.planes["u"], pic.planes["v"])
    return Picture(
        PictureSettings(pic.settings.width, pic.settings.height, RGB24),
        {"rgb": rgb},
    )
