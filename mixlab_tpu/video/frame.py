"""Video frame representation.

Rebuild of the reference's frame plumbing: ``video::Frame`` wraps a decoded
ffmpeg AvFrame plus a duration hint (``src/video.rs:7-14``), and the engine
payload adds a tick offset (``src/engine/io.rs:11-17``).  This build keeps
pixels as plain device arrays — planar uint8 YUV420 (or interleaved uint8
RGB) — so every pixel operation is a JAX/Pallas kernel.

``PictureSettings`` mirrors ``codec/src/ffmpeg/frame.rs`` PictureSettings
{width, height, pixel_format}; ``unify_picture_settings`` reproduces the
video mixer's max-box chroma-aligned target computation
(``src/module/video_mixer.rs:276-297``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from mixlab_tpu.utils.mtime import MediaDuration, MediaTime

# settings -> concrete blank Picture (see Picture.blank)
_BLANK_CACHE: Dict["PictureSettings", "Picture"] = {}

YUV420P = "yuv420p"
RGB24 = "rgb24"


@dataclass(frozen=True)
class PictureSettings:
    width: int
    height: int
    pixel_format: str = YUV420P

    # chroma subsampling (log2) per format
    @property
    def log2_chroma_w(self) -> int:
        return 1 if self.pixel_format == YUV420P else 0

    @property
    def log2_chroma_h(self) -> int:
        return 1 if self.pixel_format == YUV420P else 0

    def align_horizontal(self, x: int) -> int:
        mask = (1 << self.log2_chroma_w) - 1
        return (x + mask) & ~mask

    def align_vertical(self, y: int) -> int:
        mask = (1 << self.log2_chroma_h) - 1
        return (y + mask) & ~mask


def unify_picture_settings(a: PictureSettings, b: PictureSettings) -> PictureSettings:
    """Max box, chroma-aligned, forced yuv420p (video_mixer.rs:276-297)."""
    target = PictureSettings(
        max(a.width, b.width), max(a.height, b.height), YUV420P
    )
    return PictureSettings(
        target.align_horizontal(target.width),
        target.align_vertical(target.height),
        YUV420P,
    )


@dataclass
class Picture:
    """Planar pixel data on device.

    yuv420p: planes {"y": [H, W] u8, "u": [H/2, W/2] u8, "v": [H/2, W/2] u8}
    rgb24:   planes {"rgb": [H, W, 3] u8}
    """

    settings: PictureSettings
    planes: Dict[str, jnp.ndarray]

    @staticmethod
    def blank(settings: PictureSettings) -> "Picture":
        """Black frame; chroma planes at 0x80 (frame.rs:76-138 blank()).
        Concrete results are cached per settings: the realtime tick asks
        for one every frame, and re-uploading constant planes costs a
        dispatch each.  Under a jit trace jnp.zeros/full yield TRACERS,
        which must never enter the cache (they'd leak across traces)."""
        cached = _BLANK_CACHE.get(settings)
        if cached is not None:
            return cached
        from mixlab_tpu.utils.devhost import device_call
        from mixlab_tpu.utils.devlock import DEVICE_LOCK

        w, h = settings.width, settings.height
        if settings.pixel_format == YUV420P:

            def _make():
                with DEVICE_LOCK:
                    return {
                        "y": jnp.zeros((h, w), dtype=jnp.uint8),
                        "u": jnp.full((h >> 1, w >> 1), 0x80, dtype=jnp.uint8),
                        "v": jnp.full((h >> 1, w >> 1), 0x80, dtype=jnp.uint8),
                    }

        elif settings.pixel_format == RGB24:

            def _make():
                with DEVICE_LOCK:
                    return {"rgb": jnp.zeros((h, w, 3), dtype=jnp.uint8)}

        else:
            raise ValueError(settings.pixel_format)
        planes = device_call(_make)
        import jax

        pic = Picture(settings, planes)
        if not any(isinstance(p, jax.core.Tracer) for p in planes.values()):
            _BLANK_CACHE[settings] = pic
        return pic

    def to_numpy(self) -> Dict[str, np.ndarray]:
        from mixlab_tpu.utils.devhost import device_call
        from mixlab_tpu.utils.devlock import DEVICE_LOCK

        def _fetch():
            with DEVICE_LOCK:
                return {k: np.asarray(v) for k, v in self.planes.items()}

        return device_call(_fetch)


@dataclass
class VideoFrame:
    """Engine video payload (io.rs:11-17 + video.rs:7-14)."""

    picture: Picture
    duration_hint: MediaDuration = field(default_factory=MediaDuration.zero)
    tick_offset: MediaDuration = field(default_factory=MediaDuration.zero)
