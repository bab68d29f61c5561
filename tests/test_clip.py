"""Near-plane clipping tests: the fast path (clip -> setup -> visibility)
and exact path vs the oracle's full Sutherland-Hodgman on scenes that
straddle the camera plane."""

import numpy as np
import jax.numpy as jnp

from tyleri_tpu.ops.clip import near_clip_triangles
from tyleri_tpu.pipeline.state import (
    BlendState,
    CompareOp,
    DepthFormat,
    DepthState,
    PipelineState,
)
from tyleri_tpu.rendering import passes
from tyleri_tpu.testing import oracle
from tyleri_tpu.utils import math3d
from tyleri_tpu.utils.math3d import Rect2D, Viewport

FB = 64
FLAT = PipelineState(
    blend=BlendState(enable=False),
    depth=DepthState(test_enable=True, write_enable=True,
                     compare_op=CompareOp.LESS_OR_EQUAL,
                     format=DepthFormat.D16_UNORM),
)


def straddling_scene():
    """World-space triangles around the camera, some crossing the near plane."""
    proj = np.asarray(math3d.perspective_rh(np.radians(60), 1.0, 0.1, 100.0))
    tris_world = np.array([
        # fully in front
        [[-1, -1, -2], [1, -1, -2], [0, 1, -2]],
        # crosses the near plane: two vertices in front, one behind camera
        [[-2, 0, -1], [2, 0, -1], [0, 0.5, 1.0]],
        # one vertex in front, two behind
        [[0, -0.5, -0.5], [3, 0, 2.0], [-3, 0, 2.0]],
        # fully behind (must vanish)
        [[-1, 0, 2], [1, 0, 2], [0, 1, 3]],
    ], np.float64)
    T = len(tris_world)
    h = np.concatenate([tris_world, np.ones((T, 3, 1))], axis=2)
    clip = np.einsum("ij,tkj->tki", proj, h)
    uv = np.tile(np.array([[0.1, 0.1], [0.9, 0.1], [0.5, 0.9]]), (T, 1, 1))
    return clip, uv


def test_near_clip_triangle_counts():
    clip, uv = straddling_scene()
    ct = near_clip_triangles(
        jnp.asarray(clip, jnp.float32), jnp.asarray(uv, jnp.float32),
        jnp.zeros((4,), jnp.int32), jnp.ones((4,), bool), extra_cap=8,
    )
    valid = np.asarray(ct.valid)
    # tri0 kept, tri1 kept + 1 extra, tri2 kept (clipped), tri3 culled
    assert valid[0] and valid[1] and valid[2] and not valid[3]
    assert valid[4:].sum() == 1       # exactly one split half
    assert int(ct.overflow) == 0
    # the extra half carries tri1's draw order
    order = np.asarray(ct.order)
    extra_idx = 4 + np.argmax(valid[4:])
    assert order[extra_idx] == 1.0
    # all emitted vertices are in front of the w=eps plane
    w = np.asarray(ct.clip)[valid][..., 3]
    assert (w > 0).all()


def run_pipeline(clip, uv, exact):
    T = clip.shape[0]
    plan = passes.RasterPlan(fb_w=FB, fb_h=FB, entry_cap=4096, clip_cap=8,
                             exact=exact)
    texels = jnp.ones((1, 16), jnp.float32)
    meta = (jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32),
            jnp.ones((1,), jnp.int32))
    color = jnp.zeros((FB, FB, 4), jnp.float32)
    depth = jnp.ones((FB, FB), jnp.float32)
    color, depth, stats, _ = passes.mesh_pass(
        plan, FLAT, color, depth,
        jnp.asarray(clip, jnp.float32), jnp.asarray(uv, jnp.float32),
        jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
        Viewport(0, 0, FB, FB).as_array(), Rect2D(0, 0, FB, FB).as_array(),
        texels, *meta)
    assert int(stats.bin_overflow) == 0
    return np.asarray(color), np.asarray(depth)


def test_straddling_scene_matches_oracle():
    clip, uv = straddling_scene()
    want_c = np.zeros((FB, FB, 4), np.float64)
    want_d = np.ones((FB, FB), np.float64)
    oracle.rasterize(want_c, want_d, clip, uv, FLAT,
                     Viewport(0, 0, FB, FB), Rect2D(0, 0, FB, FB),
                     texture=np.ones((1, 1, 4)))
    for exact in (False, True):
        got_c, got_d = run_pipeline(clip, uv, exact)
        # near-plane intersections round differently in f32; allow edge noise
        bad = (np.abs(got_c - want_c).max(axis=-1) > 2e-3).mean()
        assert bad < 0.01, f"exact={exact}: {bad:.3%} color pixels differ"
        badd = (np.abs(got_d - want_d) > 1e-3).mean()
        assert badd < 0.01, f"exact={exact}: {badd:.3%} depth pixels differ"


def test_adaptive_near_clip_skip_and_reenable():
    """Near-plane clipping stays engaged through the window loop: a run of
    crossing-free frames no longer flips the plan to the cull-only pass
    (that flip only paid off with the removed fused setup kernel, and each
    flip recompiled the frame), and a late crossing triangle is clipped —
    its in-front part renders — without a plan change."""
    import numpy as np

    import tyleri_tpu as ty
    from tyleri_tpu.models import primitives as prim
    from tyleri_tpu.models.scenes import _camera, _upload, _upload_texture
    from tyleri_tpu.scene.mesh_renderer import MeshRenderer
    from tyleri_tpu.window.render_window import RenderWindow

    dev = ty.RenderDeviceBuilder().build()
    verts, idx = prim.triangle(0.6)
    v, i = _upload(dev, verts, idx)
    # a triangle spanning depth: one vertex behind the camera's near plane
    # (camera at z=2, near 0.1 => world z > 1.9 is behind it)
    sverts = np.array(
        [[-0.6, -0.6, 0.0, 0.0, 0.0],
         [0.6, -0.6, 0.0, 1.0, 0.0],
         [0.0, 0.6, 2.05, 0.5, 1.0]], np.float32)
    sv, si = _upload(dev, sverts, np.array([0, 1, 2], np.uint32))
    white = _upload_texture(dev, np.ones((1, 1, 4), np.float32))

    win = RenderWindow(dev, resolution=(64, 64), present_mode="immediate")
    rf = win.rendering_function

    def draw_frame(mesh_v, mesh_i):
        scene = win.get_render_scene()
        cam = _camera((64, 64), [0, 0, 2.0], [0, 0, 0])
        cam.mesh_renderers.append(MeshRenderer(mesh_v, mesh_i, white))
        scene.add_camera(cam)
        win.render()
        win.flush()   # drain => every frame reports its stats

    # crossing-free frames: nothing switches clipping off (there is no
    # cull-only variant to flip to), so the clip work set is untouched
    for _ in range(5):
        draw_frame(v, i)
    assert rf.plan.raster.clip_cap == 256

    # the straddling triangle is clipped on its first frame: the in-front
    # part covers pixels
    draw_frame(sv, si)
    img = win.latest_image
    assert (img[..., 0] > 0).any()
    assert not hasattr(rf, "_clip_disable_after")
