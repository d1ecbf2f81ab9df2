"""Video kernel + video mixer engine tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixlab_tpu.engine.config import EngineConfig
from mixlab_tpu.protocol import VideoMixerParams
from mixlab_tpu.utils.mtime import MediaDuration
from mixlab_tpu.video.blend import crossfade_picture, crossfade_xla
from mixlab_tpu.video.colorspace import rgb_to_yuv420, yuv420_to_rgb
from mixlab_tpu.video.engine import VideoMixerState, video_mixer_tick
from mixlab_tpu.video.frame import Picture, PictureSettings, VideoFrame, unify_picture_settings
from mixlab_tpu.video.pattern import pattern_picture
from mixlab_tpu.video.scale import letterbox_geometry, resize_matrix, scale_picture

CFG = EngineConfig(sample_rate=44_100)


def blend_oracle(a, b, fade):
    """u8/u16 truncating-division semantics of video_mixer.rs:210-235."""
    acc = a.astype(np.uint32) * fade + b.astype(np.uint32) * (255 - fade)
    return (acc // 255).astype(np.uint8)


def test_div255_multiply_shift_exact():
    x = np.arange(0, 65536, dtype=np.uint32)
    got = (x * 32897) >> 23
    np.testing.assert_array_equal(got, x // 255)


@pytest.mark.parametrize("fade", [0, 1, 127, 128, 254, 255])
def test_crossfade_xla_exact(fade):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    got = np.asarray(crossfade_xla(a, b, fade))
    np.testing.assert_array_equal(got, blend_oracle(a, b, fade))


def test_crossfade_pallas_matches_xla():
    """The video mixer's jitted all-planes crossfade (plain XLA) is
    bit-exact against the integer formula on odd-sized yuv420 planes."""
    rng = np.random.default_rng(6)
    shapes = {"y": (36, 100), "u": (18, 50), "v": (18, 50)}
    a = {k: jnp.asarray(rng.integers(0, 256, s, dtype=np.uint8))
         for k, s in shapes.items()}
    b = {k: jnp.asarray(rng.integers(0, 256, s, dtype=np.uint8))
         for k, s in shapes.items()}
    got = crossfade_picture(a, b, 171)
    for k in shapes:
        np.testing.assert_array_equal(
            np.asarray(got[k]),
            blend_oracle(np.asarray(a[k]), np.asarray(b[k]), 171))


def test_unify_picture_settings():
    a = PictureSettings(639, 360)
    b = PictureSettings(320, 481)
    u = unify_picture_settings(a, b)
    assert (u.width, u.height) == (640, 482)  # chroma-aligned max box
    assert u.pixel_format == "yuv420p"


def test_letterbox_geometry_aspect():
    # 16:9 into 4:3 -> pillar^H^H letterbox bars top/bottom
    inp = PictureSettings(1280, 720)
    out = PictureSettings(640, 480)
    x, y, sw, sh = letterbox_geometry(inp, out)
    assert (sw, sh) == (640, 360)
    assert (x, y) == (0, 60)


def test_resize_matrix_partition_of_unity():
    W = resize_matrix(720, 350)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    W = resize_matrix(350, 720)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)


def test_scale_constant_picture_stays_constant():
    pic = Picture(
        PictureSettings(64, 48),
        {
            "y": np.full((48, 64), 200, np.uint8),
            "u": np.full((24, 32), 100, np.uint8),
            "v": np.full((24, 32), 60, np.uint8),
        },
    )
    out = scale_picture(pic, PictureSettings(32, 24))
    assert np.asarray(out.planes["y"]).min() >= 199
    assert abs(int(np.asarray(out.planes["u"]).mean()) - 100) <= 1


def test_colorspace_roundtrip():
    rgb = np.asarray(pattern_picture("gradient", 64, 48, pixel_format="rgb24").planes["rgb"])
    y, u, v = rgb_to_yuv420(rgb)
    back = np.asarray(yuv420_to_rgb(y, u, v))
    # 4:2:0 subsampling loses chroma detail; compare luma-ish tolerance
    err = np.abs(back.astype(int) - rgb.astype(int))
    assert np.median(err) <= 4


def frame(w, h, t_off=0, dur_ticks=1):
    return VideoFrame(
        picture=pattern_picture("bars", w, h),
        duration_hint=MediaDuration.new(dur_ticks, CFG.ticks_per_second),
        tick_offset=MediaDuration.zero(),
    )


def test_video_mixer_compose_and_passthrough():
    state = VideoMixerState()
    params = VideoMixerParams(a=0, b=1, fader=1.0)
    fa, fb = frame(64, 48), frame(32, 48)
    out, a, b = video_mixer_tick(state, params, [fa, fb, None, None], 0, CFG)
    assert a is fa and b is fb
    assert out is not None
    # unified target = max box
    assert (out.picture.settings.width, out.picture.settings.height) == (64, 48)
    # fader=1.0 -> fade=255 -> pure A
    a_scaled = np.asarray(state.channels[0].stored.planes["y"])
    np.testing.assert_array_equal(np.asarray(out.picture.planes["y"]), a_scaled)


def test_video_mixer_no_inputs_no_output():
    state = VideoMixerState()
    out, a, b = video_mixer_tick(
        state, VideoMixerParams(a=0, b=1, fader=0.5), [None] * 4, 0, CFG
    )
    assert out is None and a is None and b is None


def test_video_mixer_stored_frame_expiry():
    state = VideoMixerState()
    params = VideoMixerParams(a=0, b=None, fader=1.0)
    spt = CFG.samples_per_tick
    # frame lasts 2 ticks
    out, _, _ = video_mixer_tick(state, params, [frame(32, 32, dur_ticks=2), None, None, None], 0, CFG)
    assert out is not None
    # tick 1: stored frame still active -> output present
    out, _, _ = video_mixer_tick(state, params, [None] * 4, spt, CFG)
    assert out is not None
    # tick 2: expired -> no output
    out, _, _ = video_mixer_tick(state, params, [None] * 4, 2 * spt, CFG)
    assert out is None


def test_video_mixer_halfway_fade():
    state = VideoMixerState()
    params = VideoMixerParams(a=0, b=1, fader=0.5)
    fa = VideoFrame(
        picture=Picture(
            PictureSettings(32, 32),
            {
                "y": np.full((32, 32), 200, np.uint8),
                "u": np.full((16, 16), 128, np.uint8),
                "v": np.full((16, 16), 128, np.uint8),
            },
        ),
        duration_hint=MediaDuration.new(1, 60),
    )
    fb = VideoFrame(
        picture=Picture(
            PictureSettings(32, 32),
            {
                "y": np.full((32, 32), 100, np.uint8),
                "u": np.full((16, 16), 128, np.uint8),
                "v": np.full((16, 16), 128, np.uint8),
            },
        ),
        duration_hint=MediaDuration.new(1, 60),
    )
    out, _, _ = video_mixer_tick(state, params, [fa, fb, None, None], 0, CFG)
    y = np.asarray(out.picture.planes["y"])
    want = (200 * 127 + 100 * 128) // 255  # fade = int(0.5*255) = 127
    np.testing.assert_array_equal(y, np.full_like(y, want))


def test_polyphase_upscale_matches_dense_matmul():
    """The integer-ratio fast path must match the dense resize matrix
    exactly (same Mitchell weights; replicate padding == edge clamp)."""
    import jax.numpy as jnp

    from mixlab_tpu.video import scale as sc

    rng = np.random.default_rng(9)
    plane = rng.integers(0, 256, (36, 52), dtype=np.uint8)

    for out_h, out_w in [(72, 104), (108, 156), (72, 52)]:
        x = jnp.asarray(plane).astype(jnp.float32)
        if out_h != 36:
            x = sc._upscale_axis(x, out_h, axis=0)
        if out_w != 52:
            x = sc._upscale_axis(x, out_w, axis=1)
        got = np.asarray(jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8))
        # dense reference
        x = plane.astype(np.float64)
        if out_h != 36:
            x = np.asarray(sc.resize_matrix(36, out_h)).astype(np.float64) @ x
        if out_w != 52:
            x = x @ np.asarray(sc.resize_matrix(52, out_w)).astype(np.float64).T
        want = np.clip(np.round(x), 0, 255).astype(np.uint8)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (out_h, out_w, diff.max())  # f32 rounding ties


def test_resize_route_choice():
    """One declared route, f32; "auto" takes it, every method stays within
    its LSB budget of f64, and an unknown method is refused."""
    from mixlab_tpu.video import scale as sc

    assert sc.RESIZE_ROUTE == "f32"
    rng = np.random.default_rng(0)
    plane = jnp.asarray(rng.integers(0, 256, (72, 128), dtype=np.uint8))
    want = np.clip(np.round(
        sc.resize_matrix(72, 108).astype(np.float64)
        @ np.asarray(plane, np.float64)
        @ sc.resize_matrix(128, 192).astype(np.float64).T), 0, 255)
    auto = np.asarray(sc.resize_plane(plane, 108, 192))
    routed = np.asarray(sc.resize_plane(plane, 108, 192,
                                        method=sc.RESIZE_ROUTE))
    np.testing.assert_array_equal(auto, routed)
    for method, lsb in (("f32", 1), ("int8", 3)):
        got = np.asarray(sc.resize_plane(plane, 108, 192, method=method))
        assert np.abs(got - want).max() <= lsb, method
    with pytest.raises(ValueError):
        sc.resize_plane(plane, 108, 192, method="bf16")


def test_resize_int8_accuracy():
    """int8 resize (s8 x s8 -> s32 matmuls) stays within ~1 LSB of the f64
    reference: per-row-scaled int8 weights, exactly-centered input, and a
    range-scaled (never clipped) intermediate between the separable passes."""
    import numpy as np

    from mixlab_tpu.video.scale import resize_matrix, resize_plane

    rng = np.random.default_rng(0)

    def f64_ref(plane, oh, ow):
        x = plane.astype(np.float64)
        ih, iw = x.shape
        if ih != oh:
            x = resize_matrix(ih, oh).astype(np.float64) @ x
        if iw != ow:
            x = x @ resize_matrix(iw, ow).astype(np.float64).T
        return np.clip(np.round(x), 0, 255)

    cases = [
        (rng.integers(0, 256, (540, 960), dtype=np.uint8), 1080, 1920),  # 2x up
        (rng.integers(0, 256, (720, 1280), dtype=np.uint8), 1080, 1920),  # 1.5x
        (rng.integers(0, 256, (1080, 1920), dtype=np.uint8), 350, 560),  # minify
        (rng.integers(0, 256, (256, 256), dtype=np.uint8), 256, 512),  # w only
        (rng.integers(0, 256, (256, 256), dtype=np.uint8), 512, 256),  # h only
        (np.kron(rng.integers(0, 2, (45, 80)),
                 np.ones((16, 16))).astype(np.uint8) * 255, 1080, 1920),  # edges
    ]
    for plane, oh, ow in cases:
        ref = f64_ref(plane, oh, ow)
        got = np.asarray(resize_plane(jnp.asarray(plane), oh, ow, method="int8"))
        err = np.abs(got.astype(np.float64) - ref)
        assert err.max() <= 3.0, (plane.shape, oh, ow, err.max())
        assert np.sqrt((err ** 2).mean()) <= 1.0, (plane.shape, oh, ow)
    # no-op passthrough unaffected by method flag
    same = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    out = np.asarray(resize_plane(jnp.asarray(same), 64, 64, method="int8"))
    assert np.array_equal(out, same)


def test_fused_resize_crossfade_roll_matches_sequential():
    """The algebraically folded resize+roll+crossfade (video/fused.py)
    matches the exact sequential pipeline within the documented envelope
    (deferred rounding: <=1 LSB on top of the resize tier's own)."""
    import numpy as np

    from mixlab_tpu.video.blend import crossfade_xla
    from mixlab_tpu.video.fused import resize_crossfade_roll
    from mixlab_tpu.video.scale import resize_plane

    from mixlab_tpu.video.scale import resize_matrix

    rng = np.random.default_rng(5)
    plane = rng.integers(0, 256, (54, 96), dtype=np.uint8)
    # f64 unclipped reference: pixels where either blended row-phase
    # overshoots [0,255] hit the documented clip-fold deviation; bound the
    # rest tightly
    Wh = resize_matrix(54, 108).astype(np.float64)
    Ww = resize_matrix(96, 192).astype(np.float64)
    ref = Wh @ plane.astype(np.float64) @ Ww.T
    overshoot = (ref < 0.5) | (ref > 254.5)
    overshoot = overshoot | np.roll(overshoot, 1, axis=0)
    for fade in (0, 67, 128, 255):
        seq_y = resize_plane(plane, 108, 192, method="f32")
        seq = np.asarray(crossfade_xla(
            seq_y, jnp.roll(seq_y, 1, axis=0), fade))
        fused = np.asarray(resize_crossfade_roll(
            plane, 108, 192, fade, method="f32"))
        err = np.abs(seq.astype(int) - fused.astype(int))
        assert err[~overshoot].max() <= 2, (fade, err[~overshoot].max())
        # overshoot pixels are bounded by the bicubic overshoot envelope
        assert err.max() <= 48, (fade, err.max())
        # and the int8 tier stays within its own documented envelope
        fused8 = np.asarray(resize_crossfade_roll(
            plane, 108, 192, fade, method="int8"))
        err8 = np.abs(seq.astype(int) - fused8.astype(int))
        assert err8[~overshoot].max() <= 6, (fade, err8[~overshoot].max())


def test_fused_tight_on_smooth_content():
    """On smooth (non-overshooting) content — the compositing norm — the
    fused op matches the sequential pipeline to <=2 LSB everywhere."""
    import numpy as np

    from mixlab_tpu.video.blend import crossfade_xla
    from mixlab_tpu.video.fused import resize_crossfade_roll
    from mixlab_tpu.video.pattern import gradient_rgb
    from mixlab_tpu.video.colorspace import rgb_to_yuv420
    from mixlab_tpu.video.scale import resize_plane

    rgb = gradient_rgb(96, 54, t=3)
    y, _, _ = rgb_to_yuv420(rgb)
    for fade in (40, 128, 220):
        seq_y = resize_plane(y, 108, 192, method="f32")
        seq = np.asarray(crossfade_xla(
            seq_y, jnp.roll(seq_y, 1, axis=0), fade))
        fused = np.asarray(resize_crossfade_roll(y, 108, 192, fade,
                                                 method="f32"))
        err = np.abs(seq.astype(int) - fused.astype(int))
        assert err.max() <= 2, (fade, err.max())


def test_fused_fade_endpoints_are_pure_resizes():
    """fade=255 must equal the plain resize; fade=0 must equal its roll."""
    import numpy as np

    from mixlab_tpu.video.fused import resize_crossfade_roll
    from mixlab_tpu.video.scale import resize_plane

    rng = np.random.default_rng(6)
    plane = rng.integers(0, 256, (32, 64), dtype=np.uint8)
    y = np.asarray(resize_plane(plane, 64, 128, method="f32"))
    full = np.asarray(resize_crossfade_roll(plane, 64, 128, 255, method="f32"))
    assert np.array_equal(full, y)
    zero = np.asarray(resize_crossfade_roll(plane, 64, 128, 0, method="f32"))
    assert np.array_equal(zero, np.roll(y, 1, axis=0))


def test_planar_colorspace_and_patterns_match_interleaved():
    """Channel-major (r, g, b) plane API: identical results to the
    interleaved [H, W, 3] path for both pattern sources and the
    YUV420 converter (video/colorspace.rgb_planes_to_yuv420)."""
    from mixlab_tpu.video.colorspace import rgb_planes_to_yuv420
    from mixlab_tpu.video.pattern import (
        gradient_planes,
        gradient_rgb,
        smpte_bars_planes,
        smpte_bars_rgb,
    )

    for w, h, t in [(64, 48, 0), (96, 54, 7)]:
        rgb = np.asarray(gradient_rgb(w, h, t=t))
        planes = [np.asarray(p) for p in gradient_planes(w, h, t=t)]
        for c in range(3):
            assert np.array_equal(rgb[:, :, c], planes[c])
        bars = np.asarray(smpte_bars_rgb(w, h, phase=t))
        bplanes = [np.asarray(p) for p in smpte_bars_planes(w, h, phase=t)]
        for c in range(3):
            assert np.array_equal(bars[:, :, c], bplanes[c])
        a = rgb_to_yuv420(rgb)
        b = rgb_planes_to_yuv420(*[np.asarray(p) for p in gradient_planes(w, h, t=t)])
        for pa, pb in zip(a, b):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_downfirst_colorspace_bound():
    """rgb_planes_to_yuv420_downfirst: the integer box sum is EXACT vs a
    numpy reference (endianness-sensitive bitcast verified here), and the
    commuted chroma matrix lands within 1 u8 LSB of the default path on
    a tiny fraction of pixels."""
    import jax.numpy as jnp

    from mixlab_tpu.video.colorspace import (
        _box2_u8,
        rgb_planes_to_yuv420_downfirst,
    )

    rng = np.random.default_rng(3)
    H, W = 64, 96
    plane = rng.integers(0, 256, (H, W), dtype=np.uint8)
    got = np.asarray(_box2_u8(jnp.asarray(plane)))
    want = plane.astype(np.uint16).reshape(H // 2, 2, W // 2, 2).sum((1, 3))
    assert np.array_equal(got, want)

    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    a = [np.asarray(p).astype(int) for p in rgb_to_yuv420(jnp.asarray(rgb))]
    b = [
        np.asarray(p).astype(int)
        for p in rgb_planes_to_yuv420_downfirst(
            jnp.asarray(rgb[..., 0]), jnp.asarray(rgb[..., 1]), jnp.asarray(rgb[..., 2])
        )
    ]
    assert np.array_equal(a[0], b[0])  # luma path is identical math
    for pa, pb in zip(a[1:], b[1:]):
        d = np.abs(pa - pb)
        assert d.max() <= 1
        assert (d != 0).mean() < 0.02


def test_resize_banded_bit_exact_vs_dense(monkeypatch):
    """The block-banded int8 resize (a measured-slower opt-in; see
    scale._banded_blocks_i8) is BIT-identical to the dense path: the band's
    zero columns contribute exactly 0 to the s32 accumulator."""
    import numpy as np

    from mixlab_tpu.video import scale

    rng = np.random.default_rng(11)
    for (ih, iw, oh, ow) in [(540, 960, 1080, 1920), (353, 561, 700, 1120),
                             (270, 480, 540, 960)]:
        x = jnp.asarray(rng.integers(0, 256, (ih, iw), dtype=np.uint8))
        monkeypatch.setenv("MIXLAB_RESIZE_BANDED", "0")
        dense = np.asarray(scale._resize_plane_int8(x, oh, ow))
        monkeypatch.setenv("MIXLAB_RESIZE_BANDED", "1")
        banded = np.asarray(scale._resize_plane_int8(x, oh, ow))
        assert np.array_equal(dense, banded), (ih, iw, oh, ow)
        # the banded form actually engaged on at least one axis
        assert (scale._banded_blocks_i8(ih, oh) is not None
                or scale._banded_blocks_i8(iw, ow) is not None)


def test_scale_host_matches_device_scaler():
    """video/scale_host.py (banded C++/numpy twin for the zero-dep publish
    tier) applies the SAME resize_matrix weights as the jax dense path;
    agreement within 3 u8 LSB on noise (summation-order differences with
    bicubic negative lobes) and identical letterbox geometry."""
    import numpy as np

    from mixlab_tpu.video.frame import Picture, PictureSettings
    from mixlab_tpu.video.scale import scale_picture
    from mixlab_tpu.video.scale_host import resize_plane_host, scale_picture_host

    rng = np.random.default_rng(3)
    for (w, h) in ((1280, 720), (320, 200), (640, 480)):
        pic = Picture(PictureSettings(w, h), {
            "y": rng.integers(0, 256, (h, w), dtype=np.uint8),
            "u": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
            "v": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)})
        out = PictureSettings(1120, 700)
        a = scale_picture(pic, out)
        b = scale_picture_host(pic, out)
        for k in a.planes:
            pa = np.asarray(a.planes[k]).astype(int)
            pb = b.planes[k].astype(int)
            assert pa.shape == pb.shape
            assert np.abs(pa - pb).max() <= 3, (w, h, k)

    # numpy fallback path agrees with the native path exactly-ish too
    plane = rng.integers(0, 256, (200, 320), dtype=np.uint8)
    from mixlab_tpu import native
    from mixlab_tpu.video.scale_host import banded_weights

    yi, yw = banded_weights(200, 700)
    xi, xw = banded_weights(320, 1120)
    nat = native.scale_plane_banded(plane, 700, 1120, yi, yw, xi, xw)
    if nat is not None:
        tmp = np.zeros((700, 320), dtype=np.float32)
        for k in range(yi.shape[1]):
            tmp += yw[:, k:k + 1] * plane[yi[:, k], :]
        acc = np.zeros((700, 1120), dtype=np.float32)
        for k in range(xi.shape[1]):
            acc += xw[None, :, k] * tmp[:, xi[:, k]]
        ref = np.clip(np.round(acc), 0, 255).astype(np.uint8)
        assert np.abs(nat.astype(int) - ref.astype(int)).max() <= 1
