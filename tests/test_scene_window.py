"""End-to-end tests of the scene/rendering/window layers: RenderDevice ->
RenderScene -> ForwardRenderingFunction -> RenderWindow frame loop -> image,
including the frames-in-flight recycling semantics of the reference
(ref: src/render_window.rs:126-218).
"""

import numpy as np

import tyleri_tpu as ty
from tyleri_tpu.models import primitives as prim
from tyleri_tpu.models import scenes as scenelib
from tyleri_tpu.scene.mesh_renderer import MeshRenderer
from tyleri_tpu.utils import math3d
from tyleri_tpu.utils.image import read_png, write_png
from tyleri_tpu.window.render_window import RenderWindow

RES = (64, 64)


def make_device():
    return ty.RenderDeviceBuilder().validation_level(ty.ValidationLevel.ERROR).build()


def test_window_renders_triangle_and_recycles_scenes(tmp_path):
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    presented = []
    win = RenderWindow(dev, resolution=RES,
                       present_target=lambda img: presented.append(img))
    n_frames = 5
    for f in range(n_frames):
        scene = win.get_render_scene()
        rig.fill(scene, f * 0.1)
        win.render()
    win.flush()
    assert win.latest_image is not None
    img = win.latest_image
    assert img.shape == (RES[1], RES[0], 4) and img.dtype == np.uint8
    # the triangle covers the center; background is the clear color (0,0,0,0)
    assert img[32, 32, 0] > 0     # lit center (white texture through blend)
    # presented alpha is opaque (reference CompositeAlpha::OPAQUE); the
    # clear corner shows in the color channels
    assert img[2, 2, :3].max() == 0 and img[2, 2, 3] == 255
    # frames-in-flight: image_count-deep pipelining presents the rest on flush
    assert len(presented) >= n_frames - win.get_swapchain_images()
    # PNG round trip
    p = str(tmp_path / "tri.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(back, img)


def test_spinning_cube_animates():
    dev = make_device()
    rig = scenelib.config2_cube(dev, RES)
    win = RenderWindow(dev, resolution=RES)
    frames = []
    for f in range(4):
        rig.fill(win.get_render_scene(), f * 0.8)
        win.render()
    win.flush()
    assert win.latest_image is not None
    # pixels covered (mesh blend writes alpha 0, so check color channels)
    assert (win.latest_image[..., :3] > 0).any()


def test_ui_overlay_occludes_mesh():
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    (white,) = dev.create_textures([((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    win = RenderWindow(dev, resolution=RES, scale_factor=1.0)
    for _ in range(2):
        scene = win.get_render_scene()
        rig.fill(scene, 0.0)
        # UI quad across the upper-left corner, in window points
        quad = [
            ((4, 4), (0, 0), (0, 1, 0, 1)),
            ((28, 4), (1, 0), (0, 1, 0, 1)),
            ((28, 16), (1, 1), (0, 1, 0, 1)),
            ((4, 16), (0, 1), (0, 1, 0, 1)),
        ]
        scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], white)])
        win.render()
    img = win.flush()
    # UI is green there, and drew first with depth write: mesh never blended in
    assert img[10, 16, 1] == 255 and img[10, 16, 0] == 0
    # outside UI the mesh is visible
    assert img[40, 32, 0] > 0


def test_ui_scale_factor_2_matches_oracle():
    """DPI golden test (VERDICT r4 item 6): at scale_factor=2.0 the UI
    points->NDC mapping divides the window size by the scale factor
    (rendering/forward.py build_frame_inputs; ref ui.vert:16-18 with the
    window/scale_factor push constants of stages.rs:56-60), so a quad
    authored in points covers TWICE the pixels.  Compares the full record()
    path against the f64 oracle fed screen_pts = window/scale."""
    from tyleri_tpu.scene.render_scene import RenderScene
    from tyleri_tpu.testing import oracle
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = make_device()
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    scene = RenderScene()
    quad = [
        ((4, 4), (0, 0), (0, 1, 0, 1)),
        ((16, 4), (1, 0), (0, 1, 0, 1)),
        ((16, 12), (1, 1), (0, 1, 0, 1)),
        ((4, 12), (0, 1), (0, 1, 0, 1)),
    ]
    idx = [0, 1, 2, 0, 2, 3]
    scene.add_ui([(quad, idx, white)])
    frame = rf.record(dev, scene.render_resources, 2.0, RES)
    got = np.asarray(frame.color)

    # the quad spans points (4,4)-(16,12) => pixels (8,8)-(32,24) at DPI 2;
    # pixel (28,20) is inside ONLY with the scale division in place
    assert got[20, 28, 1] > 0.5, "scale_factor division dropped or broken"
    assert got[20, 36, 1] == 0.0, "quad overshoots its scaled extent"

    pos = np.asarray([p for p, _, _ in quad], np.float64)
    uvs = np.asarray([uv for _, uv, _ in quad], np.float64)
    cols = np.asarray([c for _, _, c in quad], np.float64)
    tri = np.asarray(idx).reshape(-1, 3)
    w, h = RES
    o_clip = oracle.make_ui_clip(pos, np.asarray(idx), (w / 2.0, h / 2.0))
    o_color = np.zeros((h, w, 4), np.float64)
    o_depth = np.ones((h, w), np.float64)
    oracle.rasterize(o_color, o_depth, o_clip, uvs[tri], rf.ui_state,
                     math3d.Viewport(0, 0, w, h), math3d.Rect2D(0, 0, w, h),
                     texture=np.ones((1, 1, 4)), vertex_color=cols[tri])
    bad = (np.abs(got - o_color).max(axis=-1) > 1e-3).mean()
    assert bad < 0.003, f"{bad:.3%} pixels differ from the DPI-2 oracle"
    np.testing.assert_allclose(np.asarray(frame.depth), o_depth, atol=1e-6)


def test_multi_camera_viewports():
    dev = make_device()
    verts, idx = prim.triangle(0.5)
    v, i = scenelib._upload(dev, verts, idx)
    tex = scenelib._upload_texture(dev, np.ones((1, 1, 4), np.float32))
    win = RenderWindow(dev, resolution=RES)
    for _ in range(2):
        scene = win.get_render_scene()
        for half in range(2):
            cam = ty.Camera()
            cam.view_matrix = np.asarray(
                math3d.look_at_rh([0, 0, 2.2], [0, 0, 0], [0, 1, 0]), np.float32
            )
            cam.viewport = math3d.Viewport(32 * half, 0, 32, 64)
            cam.scissor = math3d.Rect2D(32 * half, 0, 32, 64)
            cam.mesh_renderers.append(MeshRenderer(v, i, tex))
            scene.add_camera(cam)
        win.render()
    img = win.flush()
    # both viewports drew their own triangle
    assert img[32, 16, 0] > 0
    assert img[32, 48, 0] > 0


def test_plan_growth_recompiles_transparently():
    dev = make_device()
    verts, idx = prim.cube(0.5)
    v, i = scenelib._upload(dev, verts, idx)
    tex = scenelib._upload_texture(dev, np.ones((1, 1, 4), np.float32))
    win = RenderWindow(dev, resolution=(32, 32))
    plan_before = win.rendering_function.plan
    # 40 draws exceeds the default draw_cap of 16 -> plan must grow
    scene = win.get_render_scene()
    cam = ty.Camera()
    cam.view_matrix = np.asarray(
        math3d.look_at_rh([0, 2, 6], [0, 0, 0], [0, 1, 0]), np.float32
    )
    cam.viewport = math3d.Viewport(0, 0, 32, 32)
    cam.scissor = math3d.Rect2D(0, 0, 32, 32)
    for k in range(40):
        model = np.asarray(math3d.translation([(k % 7) - 3, 0, (k // 7) - 3]), np.float32)
        cam.mesh_renderers.append(MeshRenderer(v, i, tex, model))
    scene.add_camera(cam)
    win.render()
    win.flush()
    assert win.rendering_function.plan.draw_cap >= 40
    assert win.rendering_function.plan != plan_before


def test_capacity_fits_converge_through_the_window_loop():
    """The demand fits (spill_level_caps, entry-slice) engage through the
    REAL feedback path — frame stats -> drain -> note_overflow -> re-plan
    — and the shrunk plan renders identical pixels."""
    dev = make_device()
    verts, idx = prim.cube(0.5)
    v, i = scenelib._upload(dev, verts, idx)
    tex = scenelib._upload_texture(dev, np.ones((1, 1, 4), np.float32))
    win = RenderWindow(dev, resolution=RES)

    def frame():
        scene = win.get_render_scene()
        cam = ty.Camera()
        cam.view_matrix = np.asarray(
            math3d.look_at_rh([0, 2, 6], [0, 0, 0], [0, 1, 0]), np.float32
        )
        cam.viewport = math3d.Viewport(0, 0, *RES)
        cam.scissor = math3d.Rect2D(0, 0, *RES)
        cam.mesh_renderers.append(
            MeshRenderer(v, i, tex, np.eye(4, dtype=np.float32)))
        scene.add_camera(cam)
        win.render()
        return win.flush()  # drains stats -> one clean feedback batch

    rf = win.rendering_function
    img_before = frame()
    cap_before = rf.plan.raster.entry_cap
    assert rf.plan.raster.spill_level_caps == ()
    for _ in range(rf._entry_shrink_after + 2):
        img_after = frame()
    assert rf.plan.raster.spill_level_caps != ()
    assert rf.plan.raster.entry_cap < cap_before
    assert rf.plan.raster.entry_cap % rf.plan.raster.chunk == 0
    np.testing.assert_array_equal(img_before, img_after)


def test_two_windows_share_one_device():
    """The reference supports several windows per device (builder window
    targets, ref: builders.rs:73-80); windows must not corrupt each other."""
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    rig2 = scenelib.config1_triangle(dev, (32, 32))
    w1 = RenderWindow(dev, resolution=RES)
    w2 = RenderWindow(dev, resolution=(32, 32))
    for f in range(3):
        rig.fill(w1.get_render_scene(), 0.1 * f)
        w1.render()
        rig2.fill(w2.get_render_scene(), 0.2 * f)
        w2.render()
    i1 = w1.flush()
    i2 = w2.flush()
    assert i1.shape == (64, 64, 4) and i2.shape == (32, 32, 4)
    assert i1[32, 32, 0] > 0 and i2[16, 16, 0] > 0


def test_fifo_presentation_paces_frames():
    """FIFO present mode blocks render() at the refresh clock (the
    mandatory vsync of ref swapchain.rs:46-51); immediate mode does not."""
    import time

    from tyleri_tpu import native
    from tyleri_tpu.models import scenes as scenelib

    if not native.available():
        import pytest

        pytest.skip(f"native runtime unavailable: {native.build_error()}")

    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config1_triangle(dev, RES)

    def run(mode, hz):
        win = RenderWindow(dev, resolution=RES, present_mode=mode, refresh_hz=hz)
        rig.fill(win.get_render_scene(), 0.2)
        win.render()  # warm compile outside the timed window
        t0 = time.perf_counter()
        n = 5
        for k in range(n):
            rig.fill(win.get_render_scene(), 0.3 + 0.01 * k)
            win.render()
        dt = time.perf_counter() - t0
        win.flush()
        return dt

    paced = run("fifo", 50.0)       # 20 ms/frame floor
    assert paced >= 5 * 0.020 * 0.7, f"FIFO did not pace: {paced:.3f}s"


def test_window_context_manager_drains():
    dev = ty.RenderDeviceBuilder().build()
    from tyleri_tpu.models import scenes as scenelib

    rig = scenelib.config1_triangle(dev, RES)
    with RenderWindow(dev, resolution=RES, present_mode="immediate") as win:
        rig.fill(win.get_render_scene(), 0.1)
        win.render()
        assert win._using  # a frame is in flight
    assert not win._using  # __exit__ drained it
    assert win.latest_image is not None


def test_window_resize_recreates_swapchain():
    """Swapchain recreation (beyond the reference, which panics): drain,
    rebuild the ring, re-target the frame program at the new size."""
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    win = RenderWindow(dev, resolution=RES)
    for _ in range(2):
        rig.fill(win.get_render_scene(), 0.0)
        win.render()
    win.flush()
    assert win.latest_image.shape == (RES[1], RES[0], 4)

    win.resize((96, 48))
    assert win.resolution == (96, 48)
    rig2 = scenelib.config1_triangle(dev, (96, 48))
    for _ in range(2):
        rig2.fill(win.get_render_scene(), 0.0)
        win.render()
    img = win.flush()
    assert img.shape == (48, 96, 4)
    assert img[24, 48, 0] > 0          # triangle center covered
    assert img[2, 2, :3].max() == 0    # clear corner (opaque present)


def test_composite_alpha_inherit_exposes_framebuffer_alpha():
    """composite_alpha="inherit" keeps the framebuffer's alpha (the mesh
    blend writes alpha 0 — ZERO/ZERO factors) in the presented image."""
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    win = RenderWindow(dev, resolution=RES, composite_alpha="inherit")
    rig.fill(win.get_render_scene(), 0.0)
    win.render()
    img = win.flush()
    assert img[32, 32, 0] > 0 and img[32, 32, 3] == 0
    assert img[2, 2, 3] == 0


def test_config3_lit_scene_renders_end_to_end():
    """BASELINE config 3 through the full public API: lit vertices upload
    (LitVertex layout), per-frame light uniform, window frame loop."""
    import numpy as np

    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.window.render_window import RenderWindow, WindowHandle

    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config3_suzanne(dev, resolution=(160, 120))
    win = RenderWindow(dev, WindowHandle(), resolution=rig.resolution)
    for t in (0.0, 0.4):
        scene = win.get_render_scene()
        rig.fill(scene, t)
        win.render(dev)
    img = win.flush()
    assert img is not None and img.shape == (120, 160, 4)
    arr = np.asarray(img).astype(np.float32)
    cov = (arr[..., :3].max(-1) > 4).mean()
    assert 0.05 < cov < 0.9, f"sphere should cover part of the frame ({cov})"
    # lighting produces shading variation across the sphere (not flat)
    lum = arr[..., :3].max(-1)
    lit_px = lum[lum > 4]
    assert lit_px.std() > 8.0, "lit sphere should show shading gradients"


def test_present_quantize_policy_and_parity():
    """present_quantize: "auto" fuses the quantize into the frame program
    below 2^20 framebuffer px and defers it above (each regime's measured
    winner, BASELINE.md round-4); explicit modes override; deferred and
    fused present bit-identical pixels; resize re-resolves the policy."""
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)

    # auto at 64x64 -> fused (plan carries the quantize)
    win = RenderWindow(dev, resolution=RES)
    assert win.rendering_function.plan.present_u8 == "opaque"
    # explicit deferred -> plan does NOT quantize; the window does
    win_d = RenderWindow(dev, resolution=RES, present_quantize="deferred")
    assert win_d.rendering_function.plan.present_u8 is None
    # explicit fused at any size
    win_f = RenderWindow(dev, resolution=RES, present_quantize="fused")
    assert win_f.rendering_function.plan.present_u8 == "opaque"

    # pixel parity between the two schedules on the same scene phase
    for w in (win_d, win_f):
        rig.fill(w.get_render_scene(), 0.3)
        w.render()
    a, b = win_d.flush(), win_f.flush()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # auto re-resolves across a resize over the 2^20-px threshold
    win.flush()
    win.resize((2048, 1024))  # 2^21 px -> deferred
    assert win.rendering_function.plan.present_u8 is None
    win.resize(RES)           # back under -> fused again
    assert win.rendering_function.plan.present_u8 == "opaque"

    try:
        RenderWindow(dev, present_quantize="sometimes")
        raise AssertionError("invalid present_quantize must be rejected")
    except ValueError:
        pass


def test_stats_drain_skips_inflight_rows(monkeypatch):
    """The background stats drain fetches only rows whose scalars have
    executed (is_ready()) — a device_get on an in-flight frame parks on
    the stream for ~a frame time.  Unready rows stay queued; flush()
    reports them all."""
    dev = make_device()
    win = RenderWindow(dev, resolution=RES)

    class Scalar:
        def __init__(self, ready):
            self.ready = ready

        def is_ready(self):
            return self.ready

    ready_row = tuple(Scalar(True) for _ in range(5))
    pending_row = tuple(Scalar(False) for _ in range(5))
    reported = []
    monkeypatch.setattr(
        win, "_report_stat_rows",
        lambda device, rows: reported.extend(rows),
    )
    win._stats_queue.extend([ready_row, pending_row])
    win._stats_inflight = True
    win._drain_stats(dev)
    assert reported == [ready_row]          # fetched the executed row only
    assert win._stats_queue == [pending_row]  # in-flight row still queued
    assert win._stats_inflight is False

    # flush() must drain unconditionally — overflow reports are never
    # silently dropped (architecture invariant)
    win.flush()
    assert pending_row in reported


def test_stats_drain_error_does_not_wedge_reporting(monkeypatch):
    """A failed background drain (device error, poisoned scalars) must
    clear the in-flight latch — otherwise no later drain is ever
    scheduled and the queue grows unboundedly — and flush() must still
    drain leftovers and in-flight frames before surfacing the error."""
    dev = make_device()
    rig = scenelib.config1_triangle(dev, RES)
    win = RenderWindow(dev, resolution=RES)

    class Boom(RuntimeError):
        pass

    def exploding(device, rows):
        raise Boom("readback failed")

    monkeypatch.setattr(win, "_report_stat_rows", exploding)
    win._stats_queue.append((None, None, None, None, None))
    win._stats_inflight = True
    try:
        win._drain_stats(dev)
        raise AssertionError("drain should re-raise")
    except Boom:
        pass
    assert win._stats_inflight is False  # latch cleared on failure

    # flush() with a failed pending drain still drains the window (the
    # presented image survives) and re-raises the drain's error at the end
    rig.fill(win.get_render_scene(), 0.0)
    win.render()
    win._stats_pending.append(win._stats_pool.submit(exploding, dev, []))
    try:
        win.flush()
        raise AssertionError("flush should surface the drain error")
    except Boom:
        pass
    assert not win._using          # in-flight frames were drained
    assert win.latest_image is not None


def test_hybrid_clip_window_loop_matches_xla():
    """A genuinely crossing scene (camera inside the mesh) through the
    PRODUCTION window loop (record -> drain -> adaptive feedback): the
    visibility kernel (interpreted on the CPU) renders the same pixels as
    the XLA path on the XLA setup + near-clip layers."""
    import dataclasses

    from tyleri_tpu.models import primitives as prim
    from tyleri_tpu.models import scenes as scenelib

    def run(kernel):
        dev = make_device()
        verts, idx = prim.cube(2.0)
        v, i = scenelib._upload(dev, verts, idx)
        tex = scenelib._upload_texture(dev, np.full((2, 2, 4), 0.9, np.float32))
        win = RenderWindow(dev, resolution=(128, 96), present_mode="immediate")
        rf = win.rendering_function
        rf.plan = dataclasses.replace(
            rf.plan,
            raster=dataclasses.replace(rf.plan.raster, pallas=kernel))
        for _ in range(8):
            scene = win.get_render_scene()
            cam = ty.Camera()
            cam.view_matrix = np.asarray(
                math3d.look_at_rh([0, 0.3, 0.8], [0, 0, 0], [0, 1, 0]),
                np.float32)
            cam.viewport = math3d.Viewport(0, 0, 128, 96)
            cam.scissor = math3d.Rect2D(0, 0, 128, 96)
            cam.mesh_renderers.append(
                MeshRenderer(v, i, tex, np.eye(4, dtype=np.float32)))
            scene.add_camera(cam)
            win.render()
        img = win.flush()
        assert rf.plan.raster.pallas is kernel
        return np.asarray(img)

    np.testing.assert_array_equal(run(True), run(False))
