"""Separable bicubic rescale as two dense matmuls + letterbox compose.

Reference: ``DynamicScaler`` (``src/video/encode.rs:310-398``) wraps
swscale's BICUBIC with aspect-preserving letterbox into a chroma-aligned
subframe.  Bit parity with swscale is impractical (SURVEY §7); this build
reimplements the same geometry with a Mitchell–Netravali bicubic (B=0,
C=0.6 — swscale's default bicubic parameterization) as a *dense separable
resample*:

    out = clip(round(W_h @ in @ W_w^T))

where W_h [H_out, H_in] and W_w [W_out, W_in] are precomputed host-side and
cached per (in, out) size pair.  Two matmuls per plane → the matrix units
do the work; u8 planes are widened to f32 on the way in and rounded back on the way
out (XLA fuses the casts into the matmuls).

Letterbox geometry matches encode.rs:354-396: integer scale ratio
min(w_ratio, h_ratio) (exact rational compare), chroma-aligned scaled size
and offsets, surrounding pixels black/0x80.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.video.frame import YUV420P, Picture, PictureSettings


def _mitchell(x: np.ndarray, B: float = 0.0, C: float = 0.6) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax < 1.0,
        ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 + (6 - 2 * B)) / 6.0,
        np.where(
            ax < 2.0,
            ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6.0,
            0.0,
        ),
    )
    return w


@functools.lru_cache(maxsize=256)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 bicubic resample matrix (edge-clamped, rows
    normalized to sum 1)."""
    scale = n_in / n_out
    # source center positions for each output pixel
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    # widen the kernel when minifying (standard anti-aliased resample)
    support = 2.0 * max(scale, 1.0)
    kscale = min(1.0, 1.0 / scale) if scale > 1.0 else 1.0
    W = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        lo = int(np.floor(pos[o] - support)) + 1
        hi = int(np.ceil(pos[o] + support))
        idx = np.arange(lo, hi + 1)
        w = _mitchell((idx - pos[o]) * kscale)
        cidx = np.clip(idx, 0, n_in - 1)
        for i, wi in zip(cidx, w):
            W[o, i] += wi
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _phase_taps(n_in: int, n_out: int):
    """For exact integer upscales (n_out = r*n_in) the dense resize matrix is
    r shifted copies of per-phase tap vectors.  Returns (r, lo, taps[r, J])
    or None when not an integer upscale.  Edge clamping in the dense matrix
    equals replicate padding here, so results match."""
    if n_out % n_in != 0 or n_out == n_in:
        return None
    r = n_out // n_in
    scale = n_in / n_out
    pos0 = (np.arange(r, dtype=np.float64) + 0.5) * scale - 0.5  # phase offsets
    lo = int(np.floor(pos0.min())) - 1
    hi = int(np.ceil(pos0.max())) + 2
    offsets = np.arange(lo, hi + 1)
    taps = _mitchell(offsets[None, :] - pos0[:, None])
    taps /= taps.sum(axis=1, keepdims=True)
    return r, lo, taps.astype(np.float32)


def _upscale_axis(x, n_out: int, axis: int):
    """Polyphase integer-ratio upscale along ``axis`` — pure shifts and
    multiply-adds, ~J FLOPs/output instead of an n_in-wide matmul."""
    n_in = x.shape[axis]
    r, lo, taps = _phase_taps(n_in, n_out)
    J = taps.shape[1]
    pad_lo = max(0, -lo)
    pad_hi = max(0, lo + J - 1)
    pad_spec = [(0, 0)] * x.ndim
    pad_spec[axis] = (pad_lo, pad_hi)
    xp = jnp.pad(x, pad_spec, mode="edge")

    phases = []
    for p in range(r):
        acc = None
        for j in range(J):
            start = pad_lo + lo + j
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(start, start + n_in)
            term = taps[p, j] * xp[tuple(sl)]
            acc = term if acc is None else acc + term
        phases.append(acc)
    stacked = jnp.stack(phases, axis=axis + 1)  # n_in then r on that axis
    new_shape = list(x.shape)
    new_shape[axis] = n_out
    return stacked.reshape(new_shape)


@functools.lru_cache(maxsize=256)
def _resize_matrix_i8(n_in: int, n_out: int):
    """int8 quantization of the bicubic resample matrix with per-row scales.

    Returns (Wq int8 [n_out, n_in], dequant f32 [n_out], offset f32 [n_out])
    such that  W @ x  ≈  (Wq @ (x - 128)) * dequant + offset + 128·(row sums
    folded into offset).  Per-row scale keeps every row at full 8-bit
    resolution; the offset term corrects the quantized rows not summing to
    exactly the dequantized 1.0."""
    return _resize_matrix_i8_from(resize_matrix(n_in, n_out))


def _resize_matrix_i8_from(W: np.ndarray):
    """Quantize an arbitrary resample-style matrix (rows summing ~1) for the
    s8 x s8 -> s32 path — also used for algebraically folded matrices
    (video/fused.py)."""
    W = np.asarray(W, dtype=np.float64)
    s = 127.0 / np.maximum(np.abs(W).max(axis=1, keepdims=True), 1e-12)
    Wq = np.clip(np.round(W * s), -127, 127).astype(np.int8)
    dequant = (1.0 / s[:, 0]).astype(np.float32)
    # exact center restore: W @ x = W @ (x-128) + 128 * rowsum(W); use the
    # QUANTIZED row sums so the +128 path carries no quantization error
    rowsum_q = Wq.astype(np.float64).sum(axis=1) / s[:, 0]
    offset = (128.0 * rowsum_q).astype(np.float32)
    # exact output bound for a centered input (|x-128| <= 128): bicubic
    # overshoot makes |W @ (x-128)| exceed 128, so the separable-pass
    # intermediate must be RANGE-SCALED into int8, never clipped
    bound = float(128.0 * np.abs(W).sum(axis=1).max())
    return Wq, dequant, offset, bound


@functools.lru_cache(maxsize=256)
def _banded_blocks_i8(n_in: int, n_out: int, block: int = 0):
    """Block-banded form of the quantized resize matrix.

    The dense [n_out, n_in] bicubic matrix is banded (each output row reads
    ~4 neighboring inputs), so an output block of ``block`` rows touches only
    a short input window.  Batching per-block [block, K] x [K, ...] matmuls
    keeps the work in matmuls while cutting the contraction from n_in to K
    — fewer MACs by n_in/K.  The
    zero columns inside each window contribute exactly 0 to the s32
    accumulator, so results are BIT-IDENTICAL to the dense int8 path
    (asserted in tests/test_video.py).

    The overlapping-window stack materializes a relayout copy, which the
    dense matmul avoids; the banded form is opt-in (MIXLAB_RESIZE_BANDED=1)
    and not measured on the GPU (tools/ab_banded_resize.py compares them).
    Bit-exactness vs dense is asserted in tests/test_video.py.

    Returns (Wb int8 [nb, block, K], starts tuple, K) or None when the band
    is too wide to save meaningful work (e.g. heavy minification)."""
    Wq, _, _, _ = _resize_matrix_i8(n_in, n_out)
    if block == 0:  # small outputs waste less on last-block padding at 128
        block = 256 if n_out >= 1024 else 128
    nb = -(-n_out // block)
    starts = []
    K = 0
    for b in range(nb):
        rows = Wq[b * block : min((b + 1) * block, n_out)]
        nz = np.nonzero((rows != 0).any(axis=0))[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1)
        starts.append(lo)
        K = max(K, hi - lo)
    K = min(n_in, -(-K // 8) * 8)  # sublane-aligned window
    if nb * block * K >= 0.6 * n_out * n_in:
        return None  # band too wide: dense is at least as good
    starts = [min(s, n_in - K) for s in starts]
    Wb = np.zeros((nb, block, K), np.int8)
    for b, s in enumerate(starts):
        rows = Wq[b * block : min((b + 1) * block, n_out)]
        Wb[b, : rows.shape[0]] = rows[:, s : s + K]
    return Wb, tuple(starts), K


def _banded_enabled() -> bool:
    import os

    # default OFF (see _banded_blocks_i8 docstring); opt-in for measurement
    return os.environ.get("MIXLAB_RESIZE_BANDED", "0") == "1"


def _int8_rows_matmul(xc, n_out: int):
    """s8 row-pass accumulator [n_out, W] s32: banded when profitable."""
    n_in = xc.shape[0]
    banded = _banded_blocks_i8(n_in, n_out) if _banded_enabled() else None
    if banded is None:
        Wq, _, _, _ = _resize_matrix_i8(n_in, n_out)
        return jnp.einsum("oi,iw->ow", jnp.asarray(Wq), xc,
                          preferred_element_type=jnp.int32)
    Wb, starts, K = banded
    xb = jnp.stack([xc[s : s + K, :] for s in starts])
    acc = jnp.einsum("brk,bkw->brw", jnp.asarray(Wb), xb,
                     preferred_element_type=jnp.int32)
    return acc.reshape(-1, xc.shape[1])[:n_out]


def _int8_cols_matmul(xc, n_out: int):
    """s8 col-pass accumulator [H, n_out] s32: banded when profitable."""
    n_in = xc.shape[1]
    banded = _banded_blocks_i8(n_in, n_out) if _banded_enabled() else None
    if banded is None:
        Wq, _, _, _ = _resize_matrix_i8(n_in, n_out)
        return jnp.einsum("hw,ow->ho", xc, jnp.asarray(Wq),
                          preferred_element_type=jnp.int32)
    Wb, starts, K = banded
    xb = jnp.stack([xc[:, s : s + K] for s in starts])
    acc = jnp.einsum("bhk,brk->bhr", xb, jnp.asarray(Wb),
                     preferred_element_type=jnp.int32)
    return acc.transpose(1, 0, 2).reshape(xc.shape[0], -1)[:, :n_out]


def _resize_plane_int8(plane, out_h: int, out_w: int):
    """Two int8 matmuls (s8 x s8 -> s32, the int8 tensor-core path).

    Planes are centered to [-128, 127] so they fit int8 exactly; the
    intermediate between the separable passes is requantized to centered
    int8 (cost: one 0.5-LSB rounding, same as any two-pass u8 resampler).
    Measured accuracy vs the f64 reference is within the bf16 path's own
    error envelope (tests/test_video.py::test_resize_int8_accuracy)."""
    in_h, in_w = plane.shape
    xc = (plane.astype(jnp.int16) - 128).astype(jnp.int8)  # exact centering
    mid_scale = 1.0  # intermediate units per original pixel unit
    if in_h != out_h:
        Wq, dq, off, bound = _resize_matrix_i8(in_h, out_h)
        acc = _int8_rows_matmul(xc, out_h)
        y = acc.astype(jnp.float32) * dq[:, None] + (off[:, None] - 128.0)
        if in_w == out_w:
            return jnp.clip(jnp.round(y) + 128.0, 0, 255).astype(jnp.uint8)
        # range-scale the centered intermediate into int8: |y| <= bound holds
        # for the unquantized W; the quantized Wq row abs-sums can slightly
        # exceed it, and XLA's f32->s8 cast wraps rather than saturates, so
        # clamp explicitly before the cast
        mid_scale = 127.0 / bound
        xc = jnp.clip(jnp.round(y * mid_scale), -127, 127).astype(jnp.int8)
    Wq, dq, off, _ = _resize_matrix_i8(in_w, out_w)
    acc = _int8_cols_matmul(xc, out_w)
    y = acc.astype(jnp.float32) * (dq[None, :] / mid_scale) + off[None, :]
    return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)


# The resize route: f32 matmuls at the backend's default precision (TF32
# tensor cores on an H100, exact f32 on the CPU), chosen on the card over
# full-f32 and int8 at the config4 and monitor/broadcast shapes (PERF.md
# "Video resize route").  "int8" (s8 x s8 -> s32) stays selectable by name.
RESIZE_ROUTE = "f32"


def resize_plane(plane, out_h: int, out_w: int, method: str = "auto"):
    """Bicubic resize of a [H, W] u8 plane via two dense matmuls.

    ``method``: "auto" (:data:`RESIZE_ROUTE`), "f32" or "int8".  A
    polyphase shift/MAC form for integer upscales exists above
    (:func:`_upscale_axis`); it is not on this path."""
    if method == "auto":
        method = RESIZE_ROUTE
    if method not in ("f32", "int8"):
        raise ValueError(f"unknown resize method {method!r}")
    in_h, in_w = plane.shape
    if method == "int8":
        if in_h != out_h or in_w != out_w:
            return _resize_plane_int8(plane, out_h, out_w)
    x = plane.astype(jnp.float32)
    # outputs are 8-bit pixels, so the default precision's reduced-mantissa
    # inputs cost at most about one LSB (PERF.md states the measured error)
    if in_h != out_h:
        Wh = jnp.asarray(resize_matrix(in_h, out_h))
        x = jnp.einsum("oi,iw->ow", Wh, x, preferred_element_type=jnp.float32)
    if in_w != out_w:
        Ww = jnp.asarray(resize_matrix(in_w, out_w))
        x = jnp.einsum("hw,ow->ho", x, Ww, preferred_element_type=jnp.float32)
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


def letterbox_geometry(
    inp: PictureSettings, out: PictureSettings
) -> Tuple[int, int, int, int]:
    """(x, y, scaled_w, scaled_h) of the content box (encode.rs:354-377)."""
    width_ratio = Fraction(out.width, inp.width)
    height_ratio = Fraction(out.height, inp.height)
    scale = min(width_ratio, height_ratio)
    scaled_w = out.align_horizontal(int(scale * inp.width))
    scaled_h = out.align_vertical(int(scale * inp.height))
    x = out.align_horizontal((out.width - scaled_w) // 2)
    y = out.align_vertical((out.height - scaled_h) // 2)
    return x, y, scaled_w, scaled_h


def _scale_planes(planes, inp: PictureSettings, out: PictureSettings):
    """Pure scale+letterbox on a yuv420p plane dict (traceable)."""
    x, y, sw, sh = letterbox_geometry(inp, out)
    base = Picture.blank(out)
    scaled = {}
    for name, (sub_x, sub_y) in (("y", (0, 0)), ("u", (1, 1)), ("v", (1, 1))):
        ph = sh >> sub_y
        pw = sw >> sub_x
        plane = resize_plane(planes[name], ph, pw)
        canvas = base.planes[name]
        py, px = y >> sub_y, x >> sub_x
        scaled[name] = canvas.at[py : py + ph, px : px + pw].set(plane)
    return scaled


@functools.lru_cache(maxsize=128)
def _scale_picture_jit(inp: PictureSettings, out: PictureSettings):
    import jax

    def f(y, u, v):
        s = _scale_planes({"y": y, "u": u, "v": v}, inp, out)
        return s["y"], s["u"], s["v"]

    return jax.jit(f)


def scale_picture(pic: Picture, out: PictureSettings) -> Picture:
    """Scale + letterbox a yuv420p picture into ``out`` settings.

    Eager callers (the realtime per-tick video pass, engine.py:705) get ONE
    compiled dispatch per (in, out) shape pair instead of per-op eager
    dispatches — essential when every dispatch pays host->device latency;
    under an enclosing jit (offline scan render) the pure path inlines."""
    if pic.settings == out:
        return pic
    assert pic.settings.pixel_format == YUV420P == out.pixel_format
    import jax

    if isinstance(pic.planes["y"], jax.core.Tracer):
        return Picture(out, _scale_planes(pic.planes, pic.settings, out))
    from mixlab_tpu.utils.devhost import device_call
    from mixlab_tpu.utils.devlock import DEVICE_LOCK

    f = _scale_picture_jit(pic.settings, out)

    def _run():
        with DEVICE_LOCK:  # codec threads scale too — serialize + re-home
            return f(pic.planes["y"], pic.planes["u"], pic.planes["v"])

    yy, uu, vv = device_call(_run)
    return Picture(out, {"y": yy, "u": uu, "v": vv})
