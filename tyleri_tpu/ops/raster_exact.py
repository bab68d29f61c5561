"""Exact-order rasterizer: sequential per-triangle processing over the full
framebuffer, bit-faithful to Vulkan per-fragment semantics (draw-order
blending, any compare op, depth write interleaving).

This path is O(T * H * W) — it is the correctness anchor (validated against
the independent numpy oracle) and the production path for the *UI overlay*,
whose triangle counts are small (ref records UI into the first secondary
command buffer, before any meshes: src/rendering_function/forward_rendering/
mod.rs:291-296; stages.rs:31-86).  Large mesh passes use the visibility
rasterizer instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tyleri_tpu.ops import setup as S
from tyleri_tpu.ops.blend import apply_blend, apply_compare
from tyleri_tpu.ops.depth import quantize_depth
from tyleri_tpu.ops.sampling import sample_bilinear
from tyleri_tpu.pipeline.state import PipelineState


@functools.partial(
    jax.jit, static_argnames=("state", "with_vertex_color", "window")
)
def rasterize_exact(
    color,        # f32 [H, W, 4]
    depth,        # f32 [H, W] (quantized values)
    clip,         # f32 [T, 3, 4]
    uv,           # f32 [T, 3, 2]
    tex_id,       # i32 [T]
    tri_valid,    # bool [T]
    viewport,     # f32 [6]
    scissor,      # i32 [4]
    texels, tex_offset, tex_width, tex_height,
    *,
    state: PipelineState,
    with_vertex_color: bool = False,
    vertex_color=None,  # f32 [T, 3, 4] when with_vertex_color
    order=None,         # f32 [T] draw order override (near-clip splits)
    window: int = 256,  # per-triangle raster window (px); triangles whose
                        # bbox fits are drawn in a dynamic-sliced window
                        # instead of a full-screen pass — UI overlays are
                        # many small quads, so this bounds the per-triangle
                        # cost at large resolutions
):
    """Returns (color, depth) after drawing the triangles in order."""
    H, W = depth.shape
    T = clip.shape[0]

    # Pixel-resolution "tile" grid so setup's bbox is the pixel bbox
    # (used for the raster windows); the grid itself costs nothing here.
    su = S.setup_triangles(
        clip, uv, tex_id, tri_valid, viewport, scissor,
        tile_w=1, tile_h=1, grid_w=max(W, 1), grid_h=max(H, 1),
        order=order,
        cull_mode=state.raster.cull_mode, front_face=state.raster.front_face,
    )
    use_window = window > 0 and window <= W and window <= H
    if with_vertex_color:
        vc = vertex_color
        # perspective-correct: interpolate (c * 1/w) then divide by 1/w
        inv_w = 1.0 / clip[..., 3]
        vc_over_w = vc * inv_w[..., None]             # [T, 3, 4]
        # plane coeffs [T, 4(rgba), 3(ABC)]; HIGHEST precision: a reduced-
        # precision product (bf16 or TF32) corrupts interpolated colors by
        # ~1e-3.
        vc_planes = jnp.einsum("tik,tic->tkc", vc_over_w, su.lam,
                               precision=jax.lax.Precision.HIGHEST)
    else:
        vc_planes = jnp.zeros((T, 0, 3), jnp.float32)

    scx, scy, scw, sch = (scissor[i] for i in range(4))
    chT = su.channels  # [T, NUM_CHANNELS]

    def raster_region(t, region_color, region_depth, ox, oy, bounds=None):
        """Draw triangle t into a region whose top-left pixel is (ox, oy).

        ``bounds`` = (gx0, gy0) restricts coverage to the logical window
        [gx0, gx0+window) x [gy0, gy0+window) — clamped windows overlap on
        screen, and a fragment must be owned by exactly one window or
        blending double-applies."""
        rh, rw = region_depth.shape
        ch = chT[t]
        xi = ox + jnp.arange(rw, dtype=jnp.int32)[None, :]
        yi = oy + jnp.arange(rh, dtype=jnp.int32)[:, None]
        xc = xi.astype(jnp.float32) + 0.5
        yc = yi.astype(jnp.float32) + 0.5
        in_scissor = (xi >= scx) & (xi < scx + scw) & (yi >= scy) & (yi < scy + sch)
        if bounds is not None:
            gx0, gy0 = bounds
            in_scissor = (
                in_scissor
                & (xi >= gx0) & (xi < gx0 + window)
                & (yi >= gy0) & (yi < gy0 + window)
            )

        def plane(row):
            return ch[row] * xc + ch[row + 1] * yc + ch[row + 2]

        meta = ch[S.CH_META].astype(jnp.int32)
        tl = meta >> S.META_TEX_BITS
        e0, e1 = plane(S.CH_E0), plane(S.CH_E1)
        e2 = (ch[S.CH_TWOA] - e0) - e1  # derived: e0+e1+e2 == |2A|
        cov = (
            ((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
            & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
            & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0)))
        )
        z = plane(S.CH_Z)
        zq = quantize_depth(z, state.depth.format)
        frag = cov & in_scissor & su.valid[t] & (z >= 0.0) & (z <= 1.0)
        if state.depth.test_enable:
            frag = frag & apply_compare(state.depth.compare_op, zq, region_depth)

        inv_w = plane(S.CH_INVW)
        denom = jnp.where(inv_w == 0, 1.0, inv_w)
        u = plane(S.CH_UW) / denom
        v = plane(S.CH_VW) / denom
        tid = meta & S.META_TEX_MASK
        tid_safe = jnp.clip(tid, 0, tex_offset.shape[0] - 1)

        def sample_tex(_):
            return sample_bilinear(
                texels, tex_offset, tex_width, tex_height, tid, u, v
            ).astype(jnp.float32)

        def solid_tex(_):
            # 1x1 texture (solid-color UI quads): one texel, no per-pixel
            # gathers — bilinear taps dominate exact-raster cost otherwise
            texel = texels[tex_offset[tid_safe]][:4]
            return jnp.broadcast_to(texel, u.shape + (4,)).astype(jnp.float32)

        is_solid = (tex_width[tid_safe] == 1) & (tex_height[tid_safe] == 1)
        src = jax.lax.cond(is_solid, solid_tex, sample_tex, None)
        if with_vertex_color:
            vcp = vc_planes[t]  # [4, 3]
            vcol = (
                vcp[:, 0][None, None] * xc[..., None]
                + vcp[:, 1][None, None] * yc[..., None]
                + vcp[:, 2][None, None]
            ) / denom[..., None]
            src = src * vcol

        blended = apply_blend(state.blend, src, region_color)
        region_color = jnp.where(frag[..., None], blended, region_color)
        if state.depth.write_enable:
            region_depth = jnp.where(frag, zq, region_depth)
        return region_color, region_depth

    def body(carry, t):
        if not use_window:
            return raster_region(
                t, carry[0], carry[1], jnp.int32(0), jnp.int32(0)
            ), None

        # Always-windowed rasterization: the triangle's bbox is covered by
        # window-sized pieces via dynamic-bound fori loops. No lax.cond —
        # XLA flattens small conds into selects (both branches execute), so
        # a "full-screen fallback branch" would run for EVERY triangle.
        # Dead triangles get zero loop iterations.
        px0 = su.tile_lo[t, 0]
        py0 = su.tile_lo[t, 1]
        px1 = su.tile_hi[t, 0]
        py1 = su.tile_hi[t, 1]
        nx = jnp.where(su.valid[t], (px1 - px0) // window + 1, 0)
        ny = jnp.where(su.valid[t], (py1 - py0) // window + 1, 0)

        def wy_loop(i, cd):
            gy0 = py0 + i * window

            def wx_loop(j, cd2):
                c, d = cd2
                gx0 = px0 + j * window
                ox = jnp.clip(gx0, 0, W - window)
                oy = jnp.clip(gy0, 0, H - window)
                sc = jax.lax.dynamic_slice(c, (oy, ox, jnp.int32(0)),
                                           (window, window, 4))
                sd = jax.lax.dynamic_slice(d, (oy, ox), (window, window))
                sc, sd = raster_region(t, sc, sd, ox, oy, bounds=(gx0, gy0))
                return (
                    jax.lax.dynamic_update_slice(c, sc, (oy, ox, jnp.int32(0))),
                    jax.lax.dynamic_update_slice(d, sd, (oy, ox)),
                )

            return jax.lax.fori_loop(0, nx, wx_loop, cd)

        return jax.lax.fori_loop(0, ny, wy_loop, carry), None

    (color, depth), _ = jax.lax.scan(body, (color, depth), jnp.arange(T))
    return color, depth
