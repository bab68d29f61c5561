"""End-to-end checks shared by chip_smoke.py, bench.py and the tests.

* ``triangle_pixel_diff`` renders the single triangle (BASELINE config 1)
  through the production record path and diffs it against the f64 numpy
  oracle, in u8 units.
* ``binned_pass`` runs one camera pass of a scene rig up to binning under a
  ForwardRenderingFunction's plan, and ``compare_visibility`` resolves those
  binned entries with the visibility kernel and with the plain XLA
  reference (ops/visibility.py) and reports how far they disagree.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


def triangle_pixel_diff(device) -> int:
    """Max |rendered - oracle| over the 512x512 triangle, in u8 units."""
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.scene.render_scene import RenderScene
    from tyleri_tpu.testing import oracle
    from tyleri_tpu.utils.math3d import Rect2D, Viewport
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    rig = scenelib.config1_triangle(device)
    rf = ty.ForwardRenderingFunction(device, ImageViewSwapchain(rig.resolution))
    scene = RenderScene()
    rig.fill(scene, 0.0)
    frame = rf.record(device, scene.render_resources, 1.0, rig.resolution)
    got = np.asarray(jax.device_get(frame.color))

    cam = scene.render_resources.cameras[0]
    mesh = cam.mesh_renderers[0]
    alloc = device.memory_allocator
    vs = slice(mesh.vertices.offset, mesh.vertices.offset + mesh.vertices.len)
    pos = alloc.static_vertices_buffer.staging("pos")[vs]
    uvs = alloc.static_vertices_buffer.staging("uv")[vs]
    idx = alloc.static_indices_buffer.staging("idx")[
        mesh.indices.offset:mesh.indices.offset + mesh.indices.len].astype(int)
    mvp = (cam.get_projection_matrix().astype(np.float64)
           @ cam.view_matrix.astype(np.float64)
           @ np.asarray(mesh.model, np.float64))
    h = np.concatenate([pos[idx], np.ones((len(idx), 1))], axis=1)
    clip = (h @ mvp.T).reshape(-1, 3, 4)
    uv3 = uvs[idx].reshape(-1, 3, 2)
    w, hgt = rig.resolution
    color = np.zeros((hgt, w, 4), np.float64)
    depth = np.ones((hgt, w), np.float64)
    oracle.rasterize(color, depth, clip, uv3, rf.common_pipeline.state,
                     Viewport(0, 0, w, hgt), Rect2D(0, 0, w, hgt),
                     texture=np.ones((1, 1, 4)))
    diff = np.abs(got.astype(np.float64) - color)
    return int(np.round(diff.max() * 255.0))


@functools.partial(jax.jit, static_argnames=("raster",))
def _setup_and_bin(raster, arrays):
    from tyleri_tpu.ops.binning import bin_triangles
    from tyleri_tpu.ops.clip import near_clip_triangles
    from tyleri_tpu.ops.setup import setup_triangles, transform_corner_table

    (_texels, _toff, _tw, _th, _clear, cam_valid, viewports, scissors,
     view_projs, models, corners, tri_draw, tri_valid0, tri_tex,
     *_rest) = arrays
    mvps = jnp.einsum("ij,djk->dik", view_projs[0], models[0],
                      precision=jax.lax.Precision.HIGHEST)
    clip, uv3 = transform_corner_table(corners[0], tri_draw[0], mvps)
    ct = near_clip_triangles(clip, uv3, tri_tex[0],
                             tri_valid0[0] & cam_valid[0],
                             extra_cap=raster.clip_cap)
    su = setup_triangles(
        ct.clip, ct.uv, ct.tex_id, ct.valid, viewports[0], scissors[0],
        tile_w=raster.tile_w, tile_h=raster.tile_h,
        grid_w=raster.grid_w, grid_h=raster.grid_h, order=ct.order)
    return bin_triangles(
        su, grid_w=raster.grid_w, grid_h=raster.grid_h,
        entry_cap=raster.entry_cap, max_tiles_per_tri=raster.max_tiles_per_tri,
        broad_cap=raster.broad_cap, spill_cap=raster.spill_cap,
        valid_cap=raster.valid_cap, spill_level_caps=raster.spill_level_caps)


def binned_pass(rf, device, rig, t: float = 0.5):
    """One frame of ``rig`` (first camera, no UI) through transform, clip,
    setup and binning under ``rf``'s plan, growing the plan on reported
    bin overflow until none is left.  Returns (arrays, binned): the frame
    inputs (textures first, as ForwardRenderingFunction builds them) and
    the BinnedEntries."""
    from tyleri_tpu.scene.render_scene import RenderScene

    for _ in range(8):
        scene = RenderScene()
        rig.fill(scene, t)
        arrays = rf.build_frame_inputs(
            device, scene.render_resources, 1.0, rig.resolution)
        binned = _setup_and_bin(rf.plan.raster, jax.device_put(arrays))
        over = int(binned.overflow)
        if over == 0:
            return arrays, binned
        rf.note_overflow(over, 0)
    raise RuntimeError(f"bin overflow did not converge ({over} entries)")


def compare_visibility(rf, arrays, binned) -> dict:
    """Resolve ``binned`` with the visibility kernel (compiled on a GPU,
    interpreted elsewhere) and with the XLA reference, shade both over a
    clear framebuffer, and report the disagreement:

    * ``owner_share`` / ``depth_share``: fraction of pixels whose winner
      entry / quantized depth differ
    * ``max_depth_steps_same_owner``: largest depth difference in D16
      steps where both resolves picked the same winner (a winner that
      differs is a coverage decision on an edge: its depth may be any)
    * ``color_share``: fraction of pixels more than 1 u8 apart
    * ``max_color_u8_same_owner``: largest u8 difference where both
      resolves picked the same winner (the shading attributes' agreement)
    """
    from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
    from tyleri_tpu.ops.shade import shade_visibility
    from tyleri_tpu.ops.visibility import rasterize_visibility
    from tyleri_tpu.rendering.passes import visibility_backend

    r = rf.plan.raster
    state = rf.mesh_state
    texels, toff, tw, th = arrays[:4]
    scissor = jnp.asarray(arrays[7][0])
    depth0 = jnp.ones((r.fb_h, r.fb_w), jnp.float32)
    backend = visibility_backend(dataclasses.replace(r, pallas=True), state)
    counts = np.diff(np.asarray(binned.tile_start))
    cap = -(-max(int(counts.max()), 1) // r.chunk) * r.chunk
    geom = dict(fb_w=r.fb_w, fb_h=r.fb_h, tile_w=r.tile_w, tile_h=r.tile_h,
                grid_w=r.grid_w, grid_h=r.grid_h, chunk=r.chunk,
                depth_state=state.depth)
    vk, _ = rasterize_visibility_pallas(
        binned, depth0, scissor, interpret=backend == "interpret", **geom)
    vx, tile_over = rasterize_visibility(
        binned, depth0, scissor, cap_per_tile=cap, **geom)
    assert int(tile_over) == 0

    @jax.jit
    def shade(vis):
        color0 = jnp.zeros((r.fb_h, r.fb_w, 4), jnp.float32)
        c = shade_visibility(vis, texels, toff, tw, th, state.blend, color0)
        return jnp.clip(jnp.round(c * 255.0), 0, 255).astype(jnp.int32)

    ck = np.asarray(shade(vk))
    cx = np.asarray(shade(vx))
    ok_, ox = np.asarray(vk.owner), np.asarray(vx.owner)
    dk, dx = np.asarray(vk.depth), np.asarray(vx.depth)
    cdiff = np.abs(ck - cx).max(axis=-1)
    same = ok_ == ox
    n = float(ok_.size)
    return {
        "pixels": int(ok_.size),
        "covered": int((ox >= 0).sum()),
        "entries": int(binned.num_entries),
        "owner_share": float((~same).sum() / n),
        "depth_share": float((dk != dx).sum() / n),
        "max_depth_steps_same_owner": float(
            np.abs(dk - dx)[same].max() * 65535.0) if same.any() else 0.0,
        "color_share": float((cdiff > 1).sum() / n),
        "max_color_u8_same_owner": int(cdiff[same].max()) if same.any() else 0,
    }
