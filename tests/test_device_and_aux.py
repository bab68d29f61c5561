"""Device builder, validation layer, profiler, UI quirks, plan growth."""

import numpy as np
import pytest

import tyleri_tpu as ty
from tyleri_tpu.device.builders import DeviceSelectionError
from tyleri_tpu.device.debug import DebugMessenger, Severity
from tyleri_tpu.rendering.forward import _cap_growth, _next_pow2
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.utils.profiling import FrameProfiler


def test_builder_defaults_mirror_reference():
    from tyleri_tpu.device import builders as B

    assert B.DEFAULT_APP_NAME == "Tyleri App"          # ref: builders.rs:29
    assert B.DEFAULT_ENGINE_NAME == "Tyleri Engine"    # ref: builders.rs:30
    assert B.DEFAULT_DEPTH_FORMAT == ty.DepthFormat.D16_UNORM  # ref: builders.rs:31
    dev = ty.RenderDeviceBuilder().build()
    assert dev.depth_format == ty.DepthFormat.D16_UNORM
    assert dev.sampler_anisotropy is None


def test_builder_fluent_config():
    dev = (
        ty.RenderDeviceBuilder()
        .app_name("my app")
        .engine_name("my engine")
        .max_sampler_anisotropy(8.0)
        .depth_format(ty.DepthFormat.D32_SFLOAT)
        .queue_pool_size(2)
        .build()
    )
    assert dev.depth_format == ty.DepthFormat.D32_SFLOAT
    assert dev.sampler_anisotropy == 8.0
    q1 = dev.present_queues.pop()
    q2 = dev.present_queues.pop()
    assert q1 is not q2
    dev.present_queues.push(q1)
    dev.present_queues.push(q2)


def test_builder_rejects_zero_queues():
    with pytest.raises(DeviceSelectionError):
        ty.RenderDeviceBuilder().queue_pool_size(0).build()


def test_debug_messenger_severity_filter():
    got = []
    m = DebugMessenger(min_severity=Severity.WARNING, callback=got.append)
    m.emit(Severity.INFO, "id1", "quiet")
    m.emit(Severity.ERROR, "id2", "loud")
    assert len(got) == 1 and got[0].message_id == "id2"
    m.check_overflow("x", 0)
    assert len(got) == 1
    m.check_overflow("x", 3)
    assert len(got) == 2 and "3 entries" in got[1].message


def test_frame_profiler_counters():
    import time

    p = FrameProfiler()
    for _ in range(5):
        p.frame(1000)
        time.sleep(0.002)
    assert p.fps() > 0
    s = p.summary()
    assert s["fps"] > 0 and s["mtris_per_s"] > 0 and s["p99_ms"] >= 0


def test_add_ui_rebuild_and_clear_quirk():
    """ref: ui.rs:57-59 — non-empty rebuilds the element list, empty clears."""
    scene = RenderScene()
    dev = ty.RenderDeviceBuilder().build()
    (tex,) = dev.create_textures([((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    quad = [((0, 0), (0, 0), (1, 1, 1, 1))] * 4
    scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], tex)])
    r = scene.render_resources
    assert len(r.ui) == 1 and r.ui_vertices.len == 4 and r.ui_indices.len == 6
    scene.add_ui([(quad, [0, 1, 2], tex), (quad, [0, 2, 3], tex)])
    assert len(r.ui) == 2 and r.ui_vertices.len == 8
    assert r.ui[1].vertex_offset == 4 and r.ui[1].index_offset == 3
    scene.add_ui([])
    assert len(r.ui) == 0 and r.ui_vertices.len == 0


def test_index_allocations_stay_triangle_aligned():
    dev = ty.RenderDeviceBuilder().build()
    handles = dev.create_indices([
        (3, lambda b: b.__setitem__(slice(None), 0)),
        (4, lambda b: b.__setitem__(slice(None), 0)),  # non-multiple of 3
        (6, lambda b: b.__setitem__(slice(None), 0)),
    ])
    for h in handles:
        assert h.offset % 3 == 0
    assert handles[1].len == 4  # logical length preserved
    handles[1].free()  # padded size freed without corruption
    (h2,) = dev.create_indices([(6, lambda b: None)])
    assert h2.offset % 3 == 0


def test_cap_growth_policy():
    # pow2 regime below the granule
    assert _cap_growth(18000, 1 << 18, 8192) == 32768
    # granule steps above it
    assert _cap_growth(3_113_368, 1 << 18, 8192) == -(-3_113_368 // (1 << 18)) * (1 << 18)
    # monotone: never below floor
    assert _cap_growth(100, 1 << 18, 65536) == 65536
    assert _next_pow2(5, 4) == 8


def test_pipeline_cache_bytes_round_trip(tmp_path, monkeypatch):
    """The reference seeds a VkPipelineCache from bytes and exports it with
    get_pipeline_cache_data (builders.rs:321-331); the analog must round
    trip actual cache CONTENTS through bytes, not just share a directory.
    A seed unpacks into JAX_COMPILATION_CACHE_DIR when it is set."""
    from tyleri_tpu.device.pipeline_cache import PipelineCache

    env_dir = tmp_path / "env_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))

    src_dir = tmp_path / "cache_a"
    src_dir.mkdir()
    (src_dir / "jit__frame-abc123").write_bytes(b"\x28\xb5\x2f\xfdfake-exe")
    (src_dir / "sub").mkdir()
    (src_dir / "sub" / "entry").write_bytes(b"nested")
    src = PipelineCache(str(src_dir))
    blob = src.get_data()
    assert isinstance(blob, bytes) and len(blob) > 0

    seeded = PipelineCache(seed=blob)  # the environment's directory
    assert seeded.enabled
    assert seeded.directory == str(env_dir)
    import os

    with open(os.path.join(seeded.directory, "jit__frame-abc123"), "rb") as f:
        assert f.read() == b"\x28\xb5\x2f\xfdfake-exe"
    with open(os.path.join(seeded.directory, "sub", "entry"), "rb") as f:
        assert f.read() == b"nested"
    # corrupt seed fails open (device creation must never die on the cache)
    bad = PipelineCache(seed=b"not a zip")
    assert not bad.enabled

    # builder surface: bytes seed accepted end-to-end
    import tyleri_tpu as ty

    dev = ty.RenderDeviceBuilder().pipeline_cache_data(blob).build()
    assert dev.pipeline_cache.enabled
    # restore the suite's shared cache dir (PipelineCache redirects the
    # process-global jax setting)
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(os.path.dirname(
                          os.path.abspath(__file__))), ".jax_cache"))


def test_anisotropic_sampling_filters_along_major_axis():
    """max_sampler_anisotropy engages real footprint filtering (ref
    builders.rs:300-320): a pixel whose footprint spans several texels in u
    must average them; a sub-texel footprint must reproduce bilinear."""
    import jax.numpy as jnp
    import numpy as np

    from tyleri_tpu.ops.sampling import (
        make_texel_quads, sample_anisotropic, sample_bilinear)

    W = H = 8
    # vertical stripes: column parity
    tex = np.zeros((W * H, 4), np.float32)
    cols = (np.arange(W * H) % W) % 2
    tex[:, :3] = cols[:, None]
    tex[:, 3] = 1.0
    quads = jnp.asarray(make_texel_quads(tex, [0], [W], [H]))
    off = jnp.asarray([0], jnp.int32)
    tw = jnp.asarray([W], jnp.int32)
    th = jnp.asarray([H], jnp.int32)
    tid = jnp.zeros((1,), jnp.int32)
    # texel center of a WHITE column (odd), mid height
    u = jnp.asarray([(1 + 0.5) / W], jnp.float32)
    v = jnp.asarray([0.5], jnp.float32)
    z = jnp.zeros_like(u)
    bil = sample_bilinear(quads, off, tw, th, tid, u, v)
    assert float(bil[0, 0]) > 0.9
    # footprint 6 texels wide in u -> averages ~half black, half white
    wide = sample_anisotropic(quads, off, tw, th, tid, u, v,
                              jnp.full_like(u, 6.0 / W), z, z, z, taps=8)
    assert 0.3 < float(wide[0, 0]) < 0.7, float(wide[0, 0])
    # sub-texel footprint -> collapses onto bilinear
    tiny = sample_anisotropic(quads, off, tw, th, tid, u, v,
                              jnp.full_like(u, 1e-5), z, z, jnp.full_like(u, 1e-5),
                              taps=8)
    np.testing.assert_allclose(np.asarray(tiny), np.asarray(bil), atol=1e-3)


def test_anisotropy_engages_in_frame_loop():
    """Builder anisotropy must reach the deferred shade via the plan and
    still render correct geometry end-to-end."""
    import numpy as np

    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.window.render_window import RenderWindow

    dev = ty.RenderDeviceBuilder().max_sampler_anisotropy(4.0).build()
    rig = scenelib.config2_cube(dev, (64, 64))
    win = RenderWindow(dev, resolution=(64, 64))
    assert win.rendering_function.plan.raster.aniso_taps == 4
    for f in range(2):
        rig.fill(win.get_render_scene(), 0.2 * f)
        win.render()
    img = win.flush()
    assert (img[..., :3].max(axis=-1) > 0).sum() > 100
