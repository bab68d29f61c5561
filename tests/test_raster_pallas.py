"""Visibility kernel (Pallas, Triton route) vs the XLA reference
implementation, in interpret mode on the CPU; chip_smoke.py compares the
compiled kernel on a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest

from tyleri_tpu.pipeline.state import (
    BlendState,
    CompareOp,
    DepthFormat,
    DepthState,
    PipelineState,
)
from tyleri_tpu.rendering import passes
from tyleri_tpu.utils.math3d import Rect2D, Viewport

FB_W, FB_H = 128, 32

FLAT = PipelineState(
    blend=BlendState(enable=False),
    depth=DepthState(test_enable=True, write_enable=True,
                     compare_op=CompareOp.LESS_OR_EQUAL,
                     format=DepthFormat.D16_UNORM),
)


def random_scene(rng, T=24, grid=16):
    xy = rng.integers(-grid - 2, grid + 3, size=(T, 3, 2)).astype(np.float64) / grid
    z = rng.integers(1, 63, size=(T,)).astype(np.float64) / 64.0
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., 0] = xy[..., 0]
    clip[..., 1] = xy[..., 1]
    clip[..., 2] = z[:, None]
    clip[..., 3] = 1.0
    uv = rng.random((T, 3, 2)).astype(np.float32)
    return clip, uv


def run(clip, uv, pallas, plan_kw=None):
    T = clip.shape[0]
    kw = dict(entry_cap=1024, cap_per_tile=512, chunk=128,
              tile_w=128, tile_h=8)
    kw.update(plan_kw or {})
    plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, pallas=pallas, **kw)
    texels = jnp.ones((4, 16), jnp.float32)
    meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
            jnp.full((1,), 2, jnp.int32))
    color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
    depth = jnp.ones((FB_H, FB_W), jnp.float32)
    color, depth, stats, _ = passes.mesh_pass(
        plan, FLAT, color, depth,
        jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
        Viewport(0, 0, FB_W, FB_H).as_array(),
        Rect2D(0, 0, FB_W, FB_H).as_array(),
        texels, *meta,
    )
    return np.asarray(color), np.asarray(depth)


@pytest.mark.parametrize("tile", [(16, 16), (32, 8), (8, 32)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_pallas_matches_xla_visibility(tile):
    rng = np.random.default_rng(21)
    clip, uv = random_scene(rng)
    kw = dict(tile_w=tile[0], tile_h=tile[1], chunk=8)
    c_ref, d_ref = run(clip, uv, pallas=False, plan_kw=kw)
    c_pal, d_pal = run(clip, uv, pallas=True, plan_kw=kw)
    np.testing.assert_array_equal(d_pal, d_ref)
    np.testing.assert_allclose(c_pal, c_ref, atol=1e-6)


def test_pallas_16row_tiles_match_xla():
    """tile_h=16 exercises the half-block row-bbox skipping path."""
    rng = np.random.default_rng(33)
    clip, uv = random_scene(rng, T=40)

    def run16(pallas):
        plan = passes.RasterPlan(
            fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=16,
            entry_cap=1024, cap_per_tile=512, chunk=128, pallas=pallas)
        texels = jnp.ones((4, 16), jnp.float32)
        meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
                jnp.full((1,), 2, jnp.int32))
        color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
        depth = jnp.ones((FB_H, FB_W), jnp.float32)
        T = clip.shape[0]
        c, d, _, _ = passes.mesh_pass(
            plan, FLAT, color, depth, jnp.asarray(clip), jnp.asarray(uv),
            jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
            Viewport(0, 0, FB_W, FB_H).as_array(),
            Rect2D(0, 0, FB_W, FB_H).as_array(), texels, *meta)
        return np.asarray(c), np.asarray(d)

    c_ref, d_ref = run16(False)
    c_pal, d_pal = run16(True)
    np.testing.assert_array_equal(d_pal, d_ref)
    np.testing.assert_allclose(c_pal, c_ref, atol=1e-6)


def test_pallas_broad_triangles_and_ties():
    # big triangle (broad list) + small ones + an exact z-tie pair
    big = [[[-4, -4, 0.9, 1], [4, -4, 0.9, 1], [0, 4, 0.9, 1]]]
    small = [[[-0.5, -0.5, 0.25, 1], [0.5, -0.5, 0.25, 1], [0, 0.5, 0.25, 1]]]
    tie = small  # same geometry/z again, later draw order wins
    clip = np.asarray(big + small + tie, np.float32)
    uv = np.zeros((3, 3, 2), np.float32)
    uv[2] = 0.9
    kw = {"max_tiles_per_tri": 2, "broad_cap": 32}
    c_ref, d_ref = run(clip, uv, pallas=False, plan_kw=kw)
    c_pal, d_pal = run(clip, uv, pallas=True, plan_kw=kw)
    np.testing.assert_array_equal(d_pal, d_ref)
    np.testing.assert_allclose(c_pal, c_ref, atol=1e-6)


def test_pallas_scissor_and_empty():
    rng = np.random.default_rng(22)
    clip, uv = random_scene(rng, T=8)
    plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=8,
                             entry_cap=512, chunk=128, pallas=True)
    texels = jnp.ones((4, 16), jnp.float32)
    meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
            jnp.full((1,), 2, jnp.int32))
    color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
    depth = jnp.ones((FB_H, FB_W), jnp.float32)
    sc = Rect2D(16, 8, 64, 16)
    c, d, _, _ = passes.mesh_pass(
        plan, FLAT, color, depth, jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((8,), jnp.int32), jnp.ones((8,), bool),
        Viewport(0, 0, FB_W, FB_H).as_array(), sc.as_array(), texels, *meta)
    c = np.asarray(c)
    outside = np.ones((FB_H, FB_W), bool)
    outside[8:24, 16:80] = False
    assert (c[outside] == 0).all()
    # empty scene
    c2, d2, _, _ = passes.mesh_pass(
        plan, FLAT, color, depth, jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), bool),
        Viewport(0, 0, FB_W, FB_H).as_array(), sc.as_array(), texels, *meta)
    assert float(jnp.sum(c2)) == 0.0


def test_pallas_flag_validation():
    """pallas=True outside the kernel's envelope (a tile side that is not
    a power of two) is refused, not silently routed elsewhere."""
    plan = passes.RasterPlan(fb_w=64, fb_h=64, tile_w=12, tile_h=8, pallas=True)
    with pytest.raises(ValueError):
        passes.visibility_backend(plan, FLAT)


def test_pallas_less_compare_first_draw_wins_ties():
    """CompareOp.LESS: equal-depth later draws must NOT overwrite."""
    from tyleri_tpu.pipeline.state import BlendState, DepthState

    less = PipelineState(
        blend=BlendState(enable=False),
        depth=DepthState(test_enable=True, write_enable=True,
                         compare_op=CompareOp.LESS,
                         format=DepthFormat.D16_UNORM),
    )
    quad = [[[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [1, 1, 0.5, 1]],
            [[-1, -1, 0.5, 1], [1, 1, 0.5, 1], [-1, 1, 0.5, 1]]]
    clip = np.asarray(quad + quad, np.float32)  # same geometry twice
    uv = np.zeros((4, 3, 2), np.float32)
    uv[2:] = 0.9
    tex = np.zeros((4, 16), np.float32)
    tex[0, :4] = [1, 0, 0, 1]   # texel 0 red (quad layout)
    tex[3, :4] = [0, 1, 0, 1]   # texel 3 green

    def run_state(pallas):
        plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=8,
                                 entry_cap=1024, chunk=128, pallas=pallas)
        meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
                jnp.full((1,), 2, jnp.int32))
        color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
        depth = jnp.ones((FB_H, FB_W), jnp.float32)
        c, d, _, _ = passes.mesh_pass(
            plan, less, color, depth, jnp.asarray(clip), jnp.asarray(uv),
            jnp.zeros((4,), jnp.int32), jnp.ones((4,), bool),
            Viewport(0, 0, FB_W, FB_H).as_array(),
            Rect2D(0, 0, FB_W, FB_H).as_array(),
            jnp.asarray(tex), *meta)
        return np.asarray(c)

    c_ref = run_state(False)
    c_pal = run_state(True)
    np.testing.assert_allclose(c_pal, c_ref, atol=1e-6)
    # first draw (red) won the tie everywhere covered
    assert c_ref[16, 64, 0] == 1.0 and c_ref[16, 64, 1] == 0.0


def test_less_tie_across_broad_and_narrow_lists():
    """CompareOp.LESS cross-list ordering: a huge (broad-list) triangle
    drawn FIRST is processed after the tile-sorted narrow list, yet must
    still win an equal-z tie against a later-drawn small triangle —
    lexicographic (z, order) min in both backends."""
    less = PipelineState(
        blend=BlendState(enable=False),
        depth=DepthState(test_enable=True, write_enable=True,
                         compare_op=CompareOp.LESS,
                         format=DepthFormat.D16_UNORM),
    )
    # z chosen so z*65535 is far from a rounding boundary: f32 plane-eval
    # noise must not flip the D16 bucket between the two triangles
    z = 16384.0 / 65535.0
    big = [[[-4, -4, z, 1], [4, -4, z, 1], [0, 4, z, 1]]]   # draw 0
    # small spans 2 tiles -> stays in the NARROW list (true cross-list tie)
    small = [[[-0.5, -0.9, z, 1], [0.5, -0.9, z, 1], [0, -0.25, z, 1]]]
    clip = np.asarray(big + small, np.float32)
    uv = np.zeros((2, 3, 2), np.float32)
    uv[1] = 0.9
    tex = np.zeros((4, 16), np.float32)
    tex[0, :4] = [1, 0, 0, 1]   # texel 0 red: big triangle samples uv=0
    tex[3, :4] = [0, 1, 0, 1]   # texel 3 green: small samples uv=0.9

    def run_state(pallas):
        plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=8,
                                 entry_cap=1024, chunk=128, pallas=pallas,
                                 max_tiles_per_tri=2, broad_cap=32)
        meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
                jnp.full((1,), 2, jnp.int32))
        color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
        depth = jnp.ones((FB_H, FB_W), jnp.float32)
        c, d, _, _ = passes.mesh_pass(
            plan, less, color, depth, jnp.asarray(clip), jnp.asarray(uv),
            jnp.zeros((2,), jnp.int32), jnp.ones((2,), bool),
            Viewport(0, 0, FB_W, FB_H).as_array(),
            Rect2D(0, 0, FB_W, FB_H).as_array(),
            jnp.asarray(tex), *meta)
        return np.asarray(c)

    for pallas in (False, True):
        c = run_state(pallas)
        covered = c[..., 3] > 0
        assert covered.any()
        # the earlier-drawn broad triangle wins every equal-z pixel
        assert (c[covered][:, 1] == 0).all(), f"green leaked (pallas={pallas})"
        assert (c[covered][:, 0] == 1.0).all()


def test_pallas_segment_pressing_entry_cap():
    """Chunk windows start unaligned at each tile's segment start; a
    segment whose end reaches entry_cap forces the clamped final window
    that re-covers processed entries (idempotent under the (z, order)
    resolve).  Tight entry_cap + one crowded tile exercises both paths."""
    rng = np.random.default_rng(7)
    # many triangles crowded into the first tile column so one tile's
    # segment ends at/near the cap
    T = 48
    xy = rng.uniform(-1, -0.2, size=(T, 3, 2))
    z = rng.integers(1, 63, size=(T,)).astype(np.float64) / 64.0
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., 0] = xy[..., 0]
    clip[..., 1] = xy[..., 1]
    clip[..., 2] = z[:, None]
    clip[..., 3] = 1.0
    uv = rng.random((T, 3, 2)).astype(np.float32)
    kw = dict(entry_cap=128, cap_per_tile=128, spill_cap=128)
    cx, dx = run(clip, uv, pallas=False, plan_kw=kw)
    cp, dp = run(clip, uv, pallas=True, plan_kw=kw)
    np.testing.assert_array_equal(dx, dp)
    np.testing.assert_array_equal(cx, cp)


def test_early_exit_skips_occluded_entries():
    """The front-to-back early exit must actually fire: a near full-cover
    quad (sorted first by CH_ZMIN) occludes hundreds of far triangles in
    the same tile.  The far entries' planes are then overwritten, behind
    the walk's back, with a plane at z=0 that would win every pixel: if the
    walk visited them the output would change, so an unchanged frame shows
    they were skipped (chunk 32: the quad's chunk is the only one walked)."""
    from tyleri_tpu.ops import setup as S
    from tyleri_tpu.ops.binning import bin_triangles
    from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
    from tyleri_tpu.ops.setup import setup_triangles
    from tyleri_tpu.pipeline.state import MESH_PIPELINE_STATE

    rng = np.random.default_rng(3)
    clip, uv = occlusion_scene(rng, n_far=400)
    T = clip.shape[0]
    su = setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.zeros((T,), jnp.int32),
        jnp.ones((T,), bool),
        jnp.array([0, 0, 16, 16, 0, 1], jnp.float32),
        jnp.array([0, 0, 16, 16], jnp.int32),
        tile_w=16, tile_h=16, grid_w=1, grid_h=1,
        order=jnp.arange(T, dtype=jnp.float32))
    b = bin_triangles(su, grid_w=1, grid_h=1, entry_cap=1024,
                      max_tiles_per_tri=4, broad_cap=8, spill_cap=512)
    assert int(b.num_entries) == T

    def resolve(binned):
        vis, _ = rasterize_visibility_pallas(
            binned, jnp.ones((16, 16), jnp.float32),
            jnp.array([0, 0, 16, 16], jnp.int32),
            fb_w=16, fb_h=16, tile_w=16, tile_h=16, grid_w=1, grid_h=1,
            chunk=32, depth_state=MESH_PIPELINE_STATE.depth, interpret=True)
        return np.asarray(vis.depth), np.asarray(vis.owner)

    d0, o0 = resolve(b)
    assert (o0 >= 0).all() and np.allclose(d0, 0.1, atol=1e-4)
    ch = np.asarray(b.entry_channels).copy()
    far = np.arange(64, T)   # entries past the first two chunks
    ch[far, S.CH_E0:S.CH_E0 + 3] = [0, 0, 1]     # e0 = e1 = 1 everywhere
    ch[far, S.CH_E1:S.CH_E1 + 3] = [0, 0, 1]
    ch[far, S.CH_TWOA] = 3.0                      # e2 = 1
    ch[far, S.CH_Z:S.CH_Z + 3] = 0.0              # z = 0: beats the quad
    d1, o1 = resolve(b._replace(entry_channels=jnp.asarray(ch)))
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(o1, o0)
    # teeth: with the exit bound defeated (every z-min 0) the poisoned
    # entries are walked and win
    ch[:, S.CH_ZMIN] = 0.0
    d2, _ = resolve(b._replace(entry_channels=jnp.asarray(ch)))
    assert (d2 == 0.0).all()


@pytest.mark.parametrize("chunk", [4, 32])
def test_kernel_occlusion_scene_matches_xla(chunk):
    """Scenes where the early exit engages, at two exit granularities:
    pixel-equal to the XLA path."""
    rng = np.random.default_rng(94)
    kw = dict(tile_w=16, tile_h=16, chunk=chunk)
    for clip, uv in (random_scene(rng, T=64), occlusion_scene(rng)):
        c_ref, d_ref = run(clip, uv, pallas=False, plan_kw=kw)
        c_k, d_k = run(clip, uv, pallas=True, plan_kw=kw)
        np.testing.assert_array_equal(d_k, d_ref)
        np.testing.assert_allclose(c_k, c_ref, atol=1e-6)


def test_pallas_broad_and_cap_pressure():
    """A broad triangle + a segment pressing against a tight entry_cap:
    the last chunk window clamps against e_cap and re-covers processed
    entries (idempotent under the associative resolve)."""
    rng = np.random.default_rng(17)
    T = 40
    xy = rng.uniform(-1, -0.1, size=(T, 3, 2))
    z = rng.integers(1, 63, size=(T,)).astype(np.float64) / 64.0
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., 0] = xy[..., 0]
    clip[..., 1] = xy[..., 1]
    clip[..., 2] = z[:, None]
    clip[..., 3] = 1.0
    big = np.array([[[-4, -4, 0.9, 1], [4, -4, 0.9, 1], [0, 4, 0.9, 1]]],
                   np.float32)
    clip = np.concatenate([big, clip], 0)
    uv = rng.random((T + 1, 3, 2)).astype(np.float32)
    kw = dict(entry_cap=128, cap_per_tile=128, spill_cap=128,
              max_tiles_per_tri=2, broad_cap=8)
    c_ref, d_ref = run(clip, uv, pallas=False, plan_kw=kw)
    c_pk, d_pk = run(clip, uv, pallas=True, plan_kw=kw)
    np.testing.assert_array_equal(d_pk, d_ref)
    np.testing.assert_allclose(c_pk, c_ref, atol=1e-6)

def occlusion_scene(rng, n_far=96):
    """A near full-cover quad (first in z-order) over many far triangles:
    the front-to-back exit threshold engages."""
    near = [[[-2, -2], [4, -2], [-2, 4]], [[4, 4], [-2, 4], [4, -2]]]
    far_xy = rng.uniform(-1, 1, (n_far, 3, 2)) * 0.9
    xy = np.concatenate([np.array(near, np.float64), far_xy], 0)
    T = xy.shape[0]
    z = np.full((T, 3), 0.9)
    z[0] = z[1] = 0.1
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., 0] = xy[..., 0]
    clip[..., 1] = xy[..., 1]
    clip[..., 2] = z
    clip[..., 3] = 1.0
    uv = rng.random((T, 3, 2)).astype(np.float32)
    return clip, uv


def _stack_scene(n_layers=3):
    """n full-cover quads at decreasing z, drawn BACK TO FRONT (draw order
    = stream order = CH_ORDER): the per-fragment blend chain visits every
    layer, deepest first."""
    quads = []
    for i in range(n_layers):
        z = 0.9 - 0.3 * i  # 0.9, 0.6, 0.3, ...
        quads.append([[[-2, -2], [4, -2], [-2, 4]], [[4, 4], [-2, 4], [4, -2]]])
        for t in quads[-1]:
            pass
    T = 2 * n_layers
    clip = np.zeros((T, 3, 4), np.float32)
    for i in range(n_layers):
        z = 0.9 - 0.3 * i
        for j, tri in enumerate([[[-2, -2], [4, -2], [-2, 4]],
                                 [[4, 4], [-2, 4], [4, -2]]]):
            clip[2 * i + j, :, 0] = [p[0] for p in tri]
            clip[2 * i + j, :, 1] = [p[1] for p in tri]
            clip[2 * i + j, :, 2] = z
            clip[2 * i + j, :, 3] = 1.0
    uv = np.tile(np.array([[0.3, 0.3], [0.7, 0.3], [0.3, 0.7]], np.float32),
                 (T, 1, 1))
    return clip, uv


MESH_BLEND = PipelineState(
    blend=BlendState(enable=True,
                     src_color=__import__("tyleri_tpu.pipeline.state",
                                          fromlist=["BlendFactor"]
                                          ).BlendFactor.SRC_COLOR,
                     dst_color=__import__("tyleri_tpu.pipeline.state",
                                          fromlist=["BlendFactor"]
                                          ).BlendFactor.ONE_MINUS_DST_COLOR,
                     src_alpha=__import__("tyleri_tpu.pipeline.state",
                                          fromlist=["BlendFactor"]
                                          ).BlendFactor.ZERO,
                     dst_alpha=__import__("tyleri_tpu.pipeline.state",
                                          fromlist=["BlendFactor"]
                                          ).BlendFactor.ZERO),
    depth=DepthState(test_enable=True, write_enable=True,
                     compare_op=CompareOp.LESS_OR_EQUAL,
                     format=DepthFormat.D16_UNORM),
)


def _run_state(clip, uv, state, plan_kw=None):
    T = clip.shape[0]
    kw = dict(entry_cap=1024, cap_per_tile=512, chunk=128)
    kw.update(plan_kw or {})
    plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=8, **kw)
    texels = jnp.full((4, 16), 0.6, jnp.float32)
    meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 2, jnp.int32),
            jnp.full((1,), 2, jnp.int32))
    color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
    depth = jnp.ones((FB_H, FB_W), jnp.float32)
    c, d, _, _ = passes.mesh_pass(
        plan, state, color, depth,
        jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
        Viewport(0, 0, FB_W, FB_H).as_array(),
        Rect2D(0, 0, FB_W, FB_H).as_array(), texels, *meta)
    return np.asarray(c), np.asarray(d)


def test_pallas_peel2_no_blend_matches_base():
    """With blending off, the layer-2 shade is overwritten by layer 1
    everywhere layer 2 exists — peel2 must be pixel-equal to base."""
    rng = np.random.default_rng(77)
    clip, uv = random_scene(rng, T=48)
    c_ref, d_ref = run(clip, uv, pallas=True)
    c_p2, d_p2 = run(clip, uv, pallas=True, plan_kw=dict(peel2=True))
    np.testing.assert_array_equal(d_p2, d_ref)
    np.testing.assert_allclose(c_p2, c_ref, atol=1e-6)


def test_pallas_peel2_two_layer_blend_matches_exact():
    """Two back-to-front layers: peel2's layer2-then-layer1 blend IS the
    full per-fragment chain — must match the exact rasterizer."""
    clip, uv = _stack_scene(n_layers=2)
    c_exact, _ = _run_state(clip, uv, MESH_BLEND, dict(exact=True))
    c_p2, _ = _run_state(clip, uv, MESH_BLEND, dict(pallas=True, peel2=True))
    np.testing.assert_allclose(c_p2, c_exact, atol=2e-6)


def _run_layers(zs, tex_ids, state, plan_kw=None):
    """Full-cover quad per z (draw order = list order), per-layer texture
    color — distinguishes WHICH fragment a layer blended, not just how
    many fragments blended."""
    clip, uv = _layers_scene(zs)
    T = clip.shape[0]
    kw = dict(entry_cap=1024, cap_per_tile=512, chunk=128)
    kw.update(plan_kw or {})
    plan = passes.RasterPlan(fb_w=FB_W, fb_h=FB_H, tile_w=128, tile_h=8, **kw)
    colors = (0.6, 0.25, 0.9)
    texels = jnp.concatenate(
        [jnp.full((4, 16), c, jnp.float32) for c in colors])
    meta = (jnp.arange(3, dtype=jnp.int32) * 4,
            jnp.full((3,), 2, jnp.int32), jnp.full((3,), 2, jnp.int32))
    tri_tex = jnp.asarray(np.repeat(np.asarray(tex_ids, np.int32), 2))
    color = jnp.zeros((FB_H, FB_W, 4), jnp.float32)
    depth = jnp.ones((FB_H, FB_W), jnp.float32)
    c, d, _, _ = passes.mesh_pass(
        plan, state, color, depth,
        jnp.asarray(clip), jnp.asarray(uv),
        tri_tex, jnp.ones((T,), bool),
        Viewport(0, 0, FB_W, FB_H).as_array(),
        Rect2D(0, 0, FB_W, FB_H).as_array(), texels, *meta)
    return np.asarray(c), np.asarray(d)


def _layers_scene(zs):
    T = 2 * len(zs)
    clip = np.zeros((T, 3, 4), np.float32)
    for i, z in enumerate(zs):
        for j, tri in enumerate([[[-2, -2], [4, -2], [-2, 4]],
                                 [[4, 4], [-2, 4], [4, -2]]]):
            clip[2 * i + j, :, 0] = [p[0] for p in tri]
            clip[2 * i + j, :, 1] = [p[1] for p in tri]
            clip[2 * i + j, :, 2] = z
            clip[2 * i + j, :, 3] = 1.0
    uv = np.tile(np.array([[0.3, 0.3], [0.7, 0.3], [0.3, 0.7]], np.float32),
                 (T, 1, 1))
    return clip, uv


def test_pallas_peel2_excludes_nonsurvivors():
    """A fragment drawn AFTER the winner with greater z never blended in
    exact mode (it failed the depth test at its draw time) — peel2 must
    not blend it either.  Draw order [near, far]: exact survivors =
    [near] only, so peel2 AND the single-layer path both equal exact; a
    naive global top-2 would wrongly blend far-then-near."""
    zs, tex = [0.3, 0.7], [0, 1]
    c_exact, _ = _run_layers(zs, tex, MESH_BLEND, dict(exact=True))
    c_base, _ = _run_layers(zs, tex, MESH_BLEND, dict(pallas=True))
    c_p2, _ = _run_layers(zs, tex, MESH_BLEND, dict(pallas=True, peel2=True))
    np.testing.assert_allclose(c_base, c_exact, atol=2e-6)
    np.testing.assert_allclose(c_p2, c_exact, atol=2e-6)


def test_pallas_peel2_layer2_is_the_prior_record():
    """Layer 2 must be the depth-record holder just before the winner
    drew, not the global second-smallest z.  Draw order [mid .5, near .3,
    between .4]: 'between' fails the exact depth test (drawn after near),
    so exact survivors are [mid, near] and layer 2 is MID — a naive top-2
    (near, between) blends the wrong fragment's color.  The three layers
    carry distinct texture colors so any wrong pairing shows."""
    zs, tex = [0.5, 0.3, 0.4], [0, 1, 2]
    c_exact, _ = _run_layers(zs, tex, MESH_BLEND, dict(exact=True))
    c_p2, _ = _run_layers(zs, tex, MESH_BLEND, dict(pallas=True, peel2=True))
    np.testing.assert_allclose(c_p2, c_exact, atol=2e-6)
    # teeth: single-layer misses the second blend entirely on this scene
    c_base, _ = _run_layers(zs, tex, MESH_BLEND, dict(pallas=True))
    assert np.abs(c_base - c_exact).max() > 0.01


def test_pallas_peel2_exit_bound_is_sound():
    """The peel-aware early exit thresholds on layer-2 depth: build a
    scene where it ENGAGES (two full-cover quads drawn last, so z2 drops
    to the second quad's depth and the many far triangles behind it get
    skipped) and require every exit granularity pixel-equal — the bound
    must never skip an entry that could still alter layer 2."""
    rng = np.random.default_rng(31)
    far_xy = rng.uniform(-1, 1, (96, 3, 2)) * 0.9
    quads, _ = _layers_scene([0.5, 0.1])  # drawn LAST (orders after fars)
    T = 96 + 4
    clip = np.zeros((T, 3, 4), np.float32)
    clip[:96, :, 0] = far_xy[..., 0]
    clip[:96, :, 1] = far_xy[..., 1]
    clip[:96, :, 2] = 0.9
    clip[:96, :, 3] = 1.0
    clip[96:] = quads
    uv = np.tile(np.array([[0.3, 0.3], [0.7, 0.3], [0.3, 0.7]], np.float32),
                 (T, 1, 1))
    outs = []
    for kw in (dict(chunk=128), dict(chunk=4), dict(chunk=1)):
        c, d = _run_state(clip, uv, MESH_BLEND,
                          dict(pallas=True, peel2=True, **kw))
        outs.append((c, d))
    for c, d in outs[1:]:
        np.testing.assert_array_equal(d, outs[0][1])
        np.testing.assert_array_equal(c, outs[0][0])
    # every pixel's survivor chain ends [quadA .5, quadB .1]: the blend is
    # the same constant everywhere (texel 0.6 through two blend steps)
    inner = outs[0][0][2:-2, 2:-2, 0]
    assert float(inner.max() - inner.min()) < 1e-6


def test_pallas_peel2_random_layer_permutations():
    """Property test of the survivor-selection rules: on full-cover layers
    with random z / draw-order / colors (including exact depth ties), the
    peel2 render must equal blend(blend(bg, s[-2]), s[-1]) over the exact
    sequential depth test's SURVIVOR chain — computed independently in
    numpy here.  Entries stream z-sorted (binning) while survivorship is
    draw-ordered, so permutations exercise the demote / revalidate / gate
    paths; ties exercise both compare ops' record rules."""
    import dataclasses

    from tyleri_tpu.ops.blend import apply_blend

    rng = np.random.default_rng(20260819)
    colors = (0.6, 0.25, 0.9)
    for case in range(12):
        le = bool(case % 2)
        n = int(rng.integers(3, 7))
        zs = np.round(rng.uniform(0.05, 0.95, n), 3)
        if case >= 4:  # inject exact depth ties
            i, j = rng.choice(n, 2, replace=False)
            zs[j] = zs[i]
        tex = rng.integers(0, 3, n)
        state = MESH_BLEND if le else dataclasses.replace(
            MESH_BLEND, depth=dataclasses.replace(
                MESH_BLEND.depth, compare_op=CompareOp.LESS))
        c_p2, _ = _run_layers(list(zs), list(tex), state,
                              dict(pallas=True, peel2=True))
        # independent survivor chain (prefix records of the D16-quantized
        # depth in draw order; LE passes ties, LESS fails them)
        rec, chain = 1.0, []
        for i in range(n):
            zq = round(float(zs[i]) * 65535.0) / 65535.0
            if zq < rec or (le and zq == rec):
                rec = zq
                chain.append(i)
        out = np.zeros(4, np.float32)
        for i in chain[-2:]:
            c = colors[tex[i]]
            src = np.array([c, c, c, c], np.float32)
            out = np.asarray(apply_blend(state.blend, src, out))
        expect = np.broadcast_to(out, c_p2.shape)
        np.testing.assert_allclose(c_p2, expect, atol=3e-6,
                                   err_msg=f"case {case} zs={zs} tex={tex} "
                                           f"le={le} chain={chain}")


def test_pallas_peel2_overdraw_deviation_bounded():
    """Three+ layers drawn back-to-front: every fragment survives, peel2
    truncates the chain to the last two survivors.  On THIS stack (bright
    0.6 color) the dropped deeper layers contribute 2 u8 vs the
    single-layer fast path's 61, and the deviation does not grow with
    stack depth.  NOTE this is scene-specific, not a universal bound: the
    blend is out = src^2 + dst*(1-dst), whose d(out)/d(dst) = 1-2*dst —
    deep layers are damped near dst=0.5 but pass through nearly linearly
    when dst is dark or bright, so real-scene deviation is measured, not
    bounded (tools/measure_blend_deviation.py)."""
    def u8(x):
        return np.round(np.clip(x, 0, 1) * 255).astype(np.int32)

    for n_layers in (3, 5):
        clip, uv = _stack_scene(n_layers=n_layers)
        c_exact, _ = _run_state(clip, uv, MESH_BLEND, dict(exact=True))
        c_base, _ = _run_state(clip, uv, MESH_BLEND, dict(pallas=True))
        c_p2, _ = _run_state(clip, uv, MESH_BLEND,
                             dict(pallas=True, peel2=True))
        err_p2 = np.abs(u8(c_p2) - u8(c_exact)).max()
        err_base = np.abs(u8(c_base) - u8(c_exact)).max()
        assert err_p2 <= 2, f"peel2 deviates {err_p2} u8 from exact"
        assert err_base >= 10 * err_p2, (err_base, err_p2)
