"""Deferred shading of a visibility buffer.

The fragment stage of the mesh pipeline is a plain texture fetch
(ref: src/pipeline/glsl/common_pipeline.frag:11-12 — ``uFragColor = color``)
followed by fixed-function blending.  The visibility pass already resolved
the winner's shading attributes per pixel (u/w, v/w, 1/w, texture slot), so
shading is one texel-quad gather + blend — no per-pixel table lookups.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tyleri_tpu.ops.blend import apply_blend
from tyleri_tpu.ops.sampling import (
    quad_derivatives,
    sample_anisotropic,
    sample_bilinear,
)
from tyleri_tpu.pipeline.state import BlendState


def blinn_phong(tex_rgba, n, p_world, light, eye):
    """The lit fragment model (scene/light.py docstring; implemented
    identically in the oracle).  ``n`` need not be normalized; a zero
    normal shades ambient-only.  light: f32 [12] uniform row."""
    l = light[:3]
    lcol = light[3:6]
    ambient, spec_s, shin = light[6], light[7], light[8]
    nn = jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True))
    n = n / jnp.where(nn == 0, 1.0, nn)
    vvec = eye - p_world
    vn = jnp.sqrt(jnp.sum(vvec * vvec, axis=-1, keepdims=True))
    vvec = vvec / jnp.where(vn == 0, 1.0, vn)
    h = l + vvec
    hn = jnp.sqrt(jnp.sum(h * h, axis=-1, keepdims=True))
    h = h / jnp.where(hn == 0, 1.0, hn)
    ndl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    ndh = jnp.maximum(jnp.sum(n * h, axis=-1), 0.0)
    spec = spec_s * ndh ** shin
    rgb = (tex_rgba[..., :3] * (ambient + lcol * ndl[..., None])
           + lcol * spec[..., None])
    return jnp.concatenate([rgb, tex_rgba[..., 3:4]], axis=-1)


def unproject_window(owner_valid, depth, viewport, inv_vp, fb_w, fb_h,
                     row0=0):
    """Window (x+.5, y+.5, depth) -> world position via the inverse
    view-projection (the lit path's position reconstruction — no extra
    per-entry channels needed).  ``row0``: frame row of the first row."""
    xc = (jnp.arange(fb_w, dtype=jnp.float32) + 0.5)[None, :]
    yc = ((row0 + jnp.arange(fb_h)).astype(jnp.float32) + 0.5)[:, None]
    vx, vy, vw, vh, dmin, dmax = (viewport[i] for i in range(6))
    ndc_x = (xc - vx) / vw * 2.0 - 1.0
    ndc_y = (yc - vy) / vh * 2.0 - 1.0
    dspan = jnp.where(dmax == dmin, 1.0, dmax - dmin)
    ndc_z = (depth - dmin) / dspan
    ndc_x, ndc_y = jnp.broadcast_to(ndc_x, depth.shape), jnp.broadcast_to(
        ndc_y, depth.shape)
    h = jnp.stack([ndc_x, ndc_y, ndc_z, jnp.ones_like(depth)], axis=-1)
    wpos = jnp.einsum("ij,hwj->hwi", inv_vp, h,
                      precision=jax.lax.Precision.HIGHEST)
    w = jnp.where(wpos[..., 3] == 0, 1.0, wpos[..., 3])
    return wpos[..., :3] / w[..., None]


def shade_visibility(
    vis,            # VisibilityBuffer (owner/uw/vw/iw/tex maps)
    texels,         # f32 [cap, 16] texel-quad arena (ops/sampling.py)
    tex_offset, tex_width, tex_height,  # i32 [slots]
    blend_state: BlendState,
    dst_color,      # f32 [H, W, 4] framebuffer to blend into
    lit=None,       # optional (nw_planes [E+B, 12], light [12], inv_vp
                    # [4,4], eye [3], viewport [6]) — Blinn-Phong path
    aniso_taps=0,   # sampler anisotropy (builders.rs:300-320): >1 engages
                    # footprint-filtered sampling with this many taps
    row0=0,         # frame row of the buffer's first row (a band)
):
    valid = vis.owner >= 0
    denom = jnp.where(vis.iw == 0, 1.0, vis.iw)
    u = vis.uw / denom
    v = vis.vw / denom
    if aniso_taps and aniso_taps > 1:
        # screen-space UV derivatives from the interpolated attribute maps
        # by 2x2 quad differencing — the same implicit-derivative scheme a
        # GPU fragment quad uses (perspective quotient rule on the
        # plane-interpolated u*w', v*w', 1/w maps; owner-boundary quads get
        # the same cross-edge noise GPU helper lanes do, bounded by the
        # spread clamp in sample_anisotropic)
        duw_dx, duw_dy = quad_derivatives(vis.uw)
        dvw_dx, dvw_dy = quad_derivatives(vis.vw)
        diw_dx, diw_dy = quad_derivatives(vis.iw)
        dudx = (duw_dx - u * diw_dx) / denom
        dudy = (duw_dy - u * diw_dy) / denom
        dvdx = (dvw_dx - v * diw_dx) / denom
        dvdy = (dvw_dy - v * diw_dy) / denom
        src = sample_anisotropic(
            texels, tex_offset, tex_width, tex_height, vis.tex, u, v,
            dudx, dvdx, dudy, dvdy, taps=int(aniso_taps))
    else:
        src = sample_bilinear(texels, tex_offset, tex_width, tex_height,
                              vis.tex, u, v)
    if lit is not None:
        nw_planes, light, inv_vp, eye, viewport = lit
        H, W = vis.owner.shape
        safe = jnp.clip(vis.owner, 0, nw_planes.shape[0] - 1)
        pl12 = nw_planes[safe]                       # [H, W, 12] row gathers
        xc = (jnp.arange(W, dtype=jnp.float32) + 0.5)[None, :]
        yc = ((row0 + jnp.arange(H)).astype(jnp.float32) + 0.5)[:, None]
        # interpolated world normal: plane-evaluate (n_k / w) then * w
        n = jnp.stack([
            pl12[..., 3 * k] * xc + pl12[..., 3 * k + 1] * yc
            + pl12[..., 3 * k + 2]
            for k in range(3)
        ], axis=-1) / denom[..., None]
        p_world = unproject_window(valid, vis.depth, viewport, inv_vp, W, H,
                                   row0)
        src = blinn_phong(src, n, p_world, light, eye)
    out = apply_blend(blend_state, src, dst_color)
    return jnp.where(valid[..., None], out, dst_color)
