"""Self-consistency tests for the numpy oracle rasterizer (Vulkan rules).

These pin down the fill convention, depth semantics, and sampler behavior
that the JAX kernels are tested against.
"""

import numpy as np

from tyleri_tpu.pipeline.state import (
    BlendState,
    CompareOp,
    DepthFormat,
    DepthState,
    MESH_PIPELINE_STATE,
    PipelineState,
)
from tyleri_tpu.testing import oracle
from tyleri_tpu.utils.math3d import Rect2D, Viewport

FLAT = PipelineState(
    blend=BlendState(enable=False),
    depth=DepthState(test_enable=True, write_enable=True,
                     compare_op=CompareOp.LESS_OR_EQUAL,
                     format=DepthFormat.D16_UNORM),
)


def fresh(h=8, w=8):
    color = np.zeros((h, w, 4), np.float64)
    depth = np.ones((h, w), np.float64)
    return color, depth


def vp(w=8, h=8):
    return Viewport(0, 0, w, h, 0.0, 1.0)


def sc(w=8, h=8):
    return Rect2D(0, 0, w, h)


def quad_clip(z=0.5):
    """Full-viewport quad as two triangles sharing the diagonal."""
    # NDC corners
    v = {
        "tl": [-1, -1, z, 1],
        "tr": [1, -1, z, 1],
        "bl": [-1, 1, z, 1],
        "br": [1, 1, z, 1],
    }
    t0 = [v["tl"], v["tr"], v["br"]]
    t1 = [v["tl"], v["br"], v["bl"]]
    return np.array([t0, t1], np.float64)


def test_fullscreen_quad_covers_every_pixel_exactly_once():
    color, depth = fresh()
    clip = quad_clip()
    uv = np.zeros((2, 3, 2))
    # additive blend would double-count a pixel covered by both triangles;
    # use an accumulating state to detect seam overlap
    from tyleri_tpu.pipeline.state import BlendFactor, BlendOp

    add = PipelineState(
        blend=BlendState(
            enable=True,
            src_color=BlendFactor.ONE, dst_color=BlendFactor.ONE, color_op=BlendOp.ADD,
            src_alpha=BlendFactor.ONE, dst_alpha=BlendFactor.ONE, alpha_op=BlendOp.ADD,
        ),
        depth=DepthState(test_enable=False, write_enable=False),
    )
    oracle.rasterize(color, depth, clip, uv, add, vp(), sc(),
                     texture=np.full((1, 1, 4), 0.25))
    # every pixel got exactly one fragment: color == 0.25 everywhere
    np.testing.assert_allclose(color, 0.25)


def test_depth_less_or_equal_later_draw_wins_on_tie():
    color, depth = fresh()
    clip = quad_clip(z=0.5)
    uv = np.zeros((2, 3, 2))
    red = np.zeros((1, 1, 4)); red[..., 0] = 1; red[..., 3] = 1
    green = np.zeros((1, 1, 4)); green[..., 1] = 1; green[..., 3] = 1
    oracle.rasterize(color, depth, clip, uv, FLAT, vp(), sc(), texture=red)
    oracle.rasterize(color, depth, clip, uv, FLAT, vp(), sc(), texture=green)
    # same depth, LESS_OR_EQUAL => the later (green) draw wins
    assert (color[..., 1] == 1).all() and (color[..., 0] == 0).all()


def test_depth_test_rejects_farther_fragment():
    color, depth = fresh()
    uv = np.zeros((2, 3, 2))
    red = np.zeros((1, 1, 4)); red[..., 0] = 1
    green = np.zeros((1, 1, 4)); green[..., 1] = 1
    oracle.rasterize(color, depth, quad_clip(z=0.25), uv, FLAT, vp(), sc(), texture=red)
    oracle.rasterize(color, depth, quad_clip(z=0.75), uv, FLAT, vp(), sc(), texture=green)
    assert (color[..., 0] == 1).all() and (color[..., 1] == 0).all()
    # depth buffer holds the near quantized value
    np.testing.assert_allclose(depth, oracle.quantize_depth(0.25, DepthFormat.D16_UNORM))


def test_half_covered_pixel_rule():
    # A triangle covering the left half of a 2x2 viewport: pixel centers at
    # x=0.5 (left column) are inside; right column outside.
    color, depth = fresh(2, 2)
    clip = np.array([[[-1, -1, 0, 1], [0, -1, 0, 1], [-1, 1, 0, 1]]], np.float64)
    uv = np.zeros((1, 3, 2))
    oracle.rasterize(color, depth, clip, uv, FLAT, vp(2, 2), sc(2, 2),
                     texture=np.ones((1, 1, 4)))
    assert color[0, 0, 0] == 1.0
    assert color[0, 1, 0] == 0.0
    assert color[1, 1, 0] == 0.0


def test_scissor_clips_fragments():
    color, depth = fresh()
    clip = quad_clip()
    uv = np.zeros((2, 3, 2))
    oracle.rasterize(color, depth, clip, uv, FLAT, vp(), Rect2D(2, 2, 3, 3),
                     texture=np.ones((1, 1, 4)))
    inside = color[2:5, 2:5, 0]
    assert (inside == 1).all()
    total = color[..., 0].sum()
    assert total == 9  # nothing outside the scissor

def test_near_plane_clipping_keeps_visible_part():
    # Triangle straddling the z=0 clip plane: two vertices in front (w>0,
    # z valid), one behind the camera. Without clipping this would explode.
    color, depth = fresh()
    clip = np.array([[[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [0, 1, -0.5, -0.5]]])
    uv = np.zeros((1, 3, 2))
    oracle.rasterize(color, depth, clip, uv, FLAT, vp(), sc(),
                     texture=np.ones((1, 1, 4)))
    # some pixels near the top edge drawn, none with invalid depth
    assert color[..., 0].sum() > 0
    assert (depth >= 0).all() and (depth <= 1).all()


def test_bilinear_sample_at_texel_centers():
    tex = np.arange(16, dtype=np.float64).reshape(2, 2, 4) / 16.0
    # texel centers: uv = ((x+0.5)/2, (y+0.5)/2)
    for y in range(2):
        for x in range(2):
            got = oracle.sample_bilinear(tex, (x + 0.5) / 2, (y + 0.5) / 2)
            np.testing.assert_allclose(got, tex[y, x], atol=1e-12)


def test_mirror_repeat_addressing():
    n = 4
    idx = np.arange(-8, 12)
    m = oracle.mirror_repeat(idx, n)
    assert (m >= 0).all() and (m < n).all()
    # mirror symmetry around the boundary: i=-1 -> 0, i=n -> n-1
    assert oracle.mirror_repeat(-1, n) == 0
    assert oracle.mirror_repeat(n, n) == n - 1
    assert oracle.mirror_repeat(2 * n, n) == 0


def test_d16_quantization():
    z = 0.5000001
    q = oracle.quantize_depth(z, DepthFormat.D16_UNORM)
    assert q != z
    assert abs(q - z) <= 0.5 / 65535
    assert oracle.quantize_depth(z, DepthFormat.D32_SFLOAT) == np.float32(z)


def test_mesh_blend_applied_in_draw_order():
    color, depth = fresh()
    uv = np.zeros((2, 3, 2))
    grey = np.full((1, 1, 4), 0.5)
    state = PipelineState(blend=MESH_PIPELINE_STATE.blend,
                          depth=DepthState(test_enable=False, write_enable=False))
    oracle.rasterize(color, depth, quad_clip(), uv, state, vp(), sc(), texture=grey)
    # first pass over clear [0,0,0,0]: rgb = 0.25, a = 0
    np.testing.assert_allclose(color[..., :3], 0.25, atol=1e-12)
    np.testing.assert_allclose(color[..., 3], 0.0)
    oracle.rasterize(color, depth, quad_clip(), uv, state, vp(), sc(), texture=grey)
    # second pass: rgb = 0.25 + 0.25*(1-0.25)
    np.testing.assert_allclose(color[..., :3], 0.25 + 0.25 * 0.75, atol=1e-12)
