"""Triangle transform + setup: the vertex stage and "triangle setup" fixed
function, as one fused jittable op.

Replaces the reference's vertex shader + rasterizer front-end
(ref: src/pipeline/glsl/common_pipeline.vert:16-19 — ``clip = projection *
view_x_model * pos`` — and Vulkan fixed-function setup).  Every
per-fragment quantity the rasterizer needs (3 edge functions, window depth,
1/w, u/w, v/w) is *affine in screen space*, so setup reduces each triangle
to 7 plane equations; downstream coverage/interpolation for a pixel tile is
then a few multiply-adds per plane (see ops/visibility.py and
ops/raster_pallas.py).

Near-plane crossers are clipped upstream of setup (ops/clip.py); this
module only drops
triangles with any vertex at w <= eps, which after clipping are the ones
entirely behind the camera.  X/Y clipping is unnecessary: offscreen
geometry is handled by the edge functions + scissor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Channel-major entry-table layout (rows of the [CHANNELS, E] table).
# Plane channels hold (A, B, C) with value(x, y) = A*x + B*y + C evaluated at
# pixel centers.
#
# The table is deliberately 24 columns (96 B rows): binning gathers one row
# per (tile, triangle) entry every frame and the visibility kernel reads each
# entry's row, so the texture slot and the three top-left-edge bits share one
# packed META column, and the tile-bbox fields live in setup.tile_lo/tile_hi
# (binning builds its own packed side table from those).
CH_E0 = 0    # edge 0 (opposite vertex 0) A,B,C at rows 0..2
CH_E1 = 3
# Edge 2 is DERIVED, not stored: the sign-normalized edge functions satisfy
# e0 + e1 + e2 = |2A| identically, so both rasterizers reconstruct
# e2 = (|2A| - e0) - e1 from the stored doubled area — 2 fewer scalar loads
# per entry in the visibility kernel.  Rows CH_TWOA+1/+2
# are zero.  For small-integer coordinates (UI quads, test scenes) the f32
# subtraction is exact, so e2 == 0 top-left ties are preserved bit-exactly;
# at scene scale the absolute wobble is ~ulp(|2A|), far below the f32 noise
# the golden edge-pixel budgets already absorb.  Both the XLA and Pallas
# paths use the identical expression, so cross-backend parity stays exact.
CH_TWOA = 6
CH_Z = 9     # window-space depth plane
CH_INVW = 12  # 1/w plane
CH_UW = 15   # u/w plane
CH_VW = 18   # v/w plane
CH_META = 21  # packed (topleft bits << 18) | texture slot, exact in f32
CH_ORDER = 22  # draw-order id (depth-tie arbitration + order map)
CH_ZMIN = 23  # conservative window-z lower bound in D16 quanta (0..65535,
              # exact in f32) — binning's front-to-back in-tile sort key and
              # the visibility kernel's early-exit bound (_zmin_quantized)
NUM_CHANNELS = 24

# META packing: tex in the low bits, the three top-left-edge flags above.
# Max value 7 * 2^18 + (2^18 - 1) < 2^24: exact in f32.
META_TEX_BITS = 18
META_TEX_MASK = (1 << META_TEX_BITS) - 1


def meta_pack(tex_id, topleft):
    """tex_id i32 [...], topleft f32 [..., 3] of 0/1 flags -> f32 META."""
    tl_bits = (
        topleft[..., 0] + 2.0 * topleft[..., 1] + 4.0 * topleft[..., 2]
    )
    texf = jnp.clip(tex_id, 0, META_TEX_MASK).astype(jnp.float32)
    return tl_bits * float(1 << META_TEX_BITS) + texf

W_EPS = 1e-6

# Early-exit z-bound slack, in D16 quanta: covers the f32 rounding of the
# kernel's 2-FMA plane evaluation plus the half-quantum of D16 rounding.
# 66 quanta ~ 1e-3 in window z; triangles whose plane-evaluation error bound
# exceeds the slack (steep z slivers, z-range outside [0, 1]) get zmin 0 and
# are simply never skipped — the bound is *conservative*, never wrong.
ZMIN_SLACK_Q = 66.0


def _zmin_quantized(sz, zA, zB, zC, fb_w, fb_h):
    """Per-triangle lower bound of the rasterizer's quantized depth.

    The visibility resolve is an associative per-pixel lexicographic min over
    (quantized z, draw order), so tiles may process entries front-to-back and
    stop once every pixel's depth is below the next entry's bound.  The bound
    must hold against the KERNEL's f32 evaluation ``zA*x + zB*y + zC`` at any
    covered pixel center: window z is affine, so its exact minimum over the
    triangle is the corner minimum; f32 evaluation error is bounded by
    ~8 ulp of the largest term magnitude, and D16 round-to-nearest moves the
    value by at most half a quantum.  Triangles where that error bound
    exceeds ZMIN_SLACK_Q quanta (or whose corner z leaves [0, 1]) return 0 —
    they sort first and are never skipped."""
    zmin = jnp.min(sz, axis=1)
    zmax = jnp.max(sz, axis=1)
    in_range = (zmin >= 0.0) & (zmax <= 1.0)
    err = (jnp.abs(zA) * fb_w + jnp.abs(zB) * fb_h + jnp.abs(zC)) * (
        8.0 * 2.0 ** -24
    )
    safe = in_range & (err * 65535.0 < ZMIN_SLACK_Q)
    q = jnp.clip(jnp.floor(zmin * 65535.0) - ZMIN_SLACK_Q, 0.0, 65535.0)
    return jnp.where(safe, q, 0.0)


class TriangleSetup(NamedTuple):
    """Per-triangle rasterization data, [T]-leading static shapes."""

    valid: jax.Array      # bool [T]
    channels: jax.Array   # f32 [T, NUM_CHANNELS] entry-major plane table
                          # (row per triangle: gathers/DMAs stay contiguous)
    tile_lo: jax.Array    # i32 [T, 2] inclusive tile bbox (tx0, ty0)
    tile_hi: jax.Array    # i32 [T, 2] inclusive tile bbox (tx1, ty1)
    lam: jax.Array        # f32 [T, 3, 3] barycentric planes: lam[t, i] = (A, B, C)
                          # of lambda_i, for interpolating extra attributes


def viewport_transform(clip, viewport):
    """Clip space -> window space. ``clip`` [..., 4], viewport f32[6]
    (x, y, w, h, min_depth, max_depth); Vulkan y-down convention."""
    w = clip[..., 3]
    inv_w = 1.0 / w
    ndc = clip[..., :3] * inv_w[..., None]
    vx, vy, vw, vh, dmin, dmax = (viewport[i] for i in range(6))
    sx = (ndc[..., 0] * 0.5 + 0.5) * vw + vx
    sy = (ndc[..., 1] * 0.5 + 0.5) * vh + vy
    sz = dmin + ndc[..., 2] * (dmax - dmin)
    return sx, sy, sz, inv_w


def cull_keep_mask(area2, cull_mode, front_face):
    """Vulkan cull test (spec 28.8): orientation from the y-down shoelace
    signed area — positive <=> counter-clockwise in framebuffer coords.
    Mirrors the oracle (testing/oracle.py:241-250); the reference's default
    is NONE (ref: src/pipeline/common_pipeline.rs:96-102)."""
    from tyleri_tpu.pipeline.state import CullMode, FrontFace

    if cull_mode == CullMode.NONE:
        return None
    if cull_mode == CullMode.FRONT_AND_BACK:
        return jnp.zeros(area2.shape, bool)
    is_front = (area2 > 0) == (front_face == FrontFace.COUNTER_CLOCKWISE)
    return is_front if cull_mode == CullMode.BACK else ~is_front


@functools.partial(jax.jit, static_argnames=(
    "tile_w", "tile_h", "grid_w", "grid_h", "cull_mode", "front_face"))
def setup_triangles(
    clip,       # f32 [T, 3, 4] clip-space corner positions
    uv,         # f32 [T, 3, 2] per-corner texcoords
    tex_id,     # i32 [T] texture slot per triangle
    tri_valid,  # bool [T] upstream validity (padding/draw masks)
    viewport,   # f32 [6]
    scissor,    # i32 [4] (x, y, w, h)
    *,
    tile_w: int,
    tile_h: int,
    grid_w: int,
    grid_h: int,
    order=None,  # f32 [T] draw order (defaults to the slot index); near-plane
                 # clipping passes the ORIGINAL order for split halves
    cull_mode=None,   # pipeline cull state (static; None = CullMode.NONE)
    front_face=None,
    row0=0,      # i32 [] first framebuffer row of the tile grid (a band of
                 # a sharded frame); planes stay in frame coordinates
) -> TriangleSetup:
    from tyleri_tpu.pipeline.state import CullMode, FrontFace

    if cull_mode is None:
        cull_mode = CullMode.NONE
    if front_face is None:
        front_face = FrontFace.COUNTER_CLOCKWISE
    T = clip.shape[0]
    if order is None:
        order = jnp.arange(T, dtype=jnp.float32)

    w = clip[..., 3]
    in_front = jnp.all(w > W_EPS, axis=1)

    safe_clip = jnp.where(in_front[:, None, None], clip, jnp.ones_like(clip))
    sx, sy, sz, inv_w = viewport_transform(safe_clip, viewport)  # each [T, 3]

    # Signed doubled area (shoelace, y-down framebuffer coords).
    area2 = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - (
        sy[:, 1] - sy[:, 0]
    ) * (sx[:, 2] - sx[:, 0])
    nondegenerate = area2 != 0.0
    sgn = jnp.where(area2 > 0, 1.0, -1.0)
    inv_abs_area2 = sgn / jnp.where(nondegenerate, area2, 1.0)

    # Edge i (opposite vertex i) from a=(i+1)%3 to b=(i+2)%3:
    #   E_i(p) = ((py - ay)*dx - (px - ax)*dy) * sgn
    #   expanded: A = -dy*sgn, B = dx*sgn, C = (ax*dy - ay*dx)*sgn
    # (slice+concat cyclic rotations instead of static-permutation fancy
    # indexing, which lowers to gathers)
    def rot1(a):
        return jnp.concatenate([a[:, 1:3], a[:, 0:1]], axis=1)

    def rot2(a):
        return jnp.concatenate([a[:, 2:3], a[:, 0:2]], axis=1)

    ax_, ay_ = rot1(sx), rot1(sy)     # [T, 3]
    bx_, by_ = rot2(sx), rot2(sy)
    dx = bx_ - ax_
    dy = by_ - ay_
    eA = -dy * sgn[:, None]
    eB = dx * sgn[:, None]
    eC = (ax_ * dy - ay_ * dx) * sgn[:, None]

    # Top-left rule (y-down, interior-positive effective direction):
    edx = dx * sgn[:, None]
    edy = dy * sgn[:, None]
    topleft = jnp.where((edy < 0) | ((edy == 0) & (edx > 0)), 1.0, 0.0)

    # Interpolation planes: lambda_i = E_i / |2A|; plane(attr) = sum_i attr_i * E_i/|2A|
    lamA = eA * inv_abs_area2[:, None]  # [T, 3]
    lamB = eB * inv_abs_area2[:, None]
    lamC = eC * inv_abs_area2[:, None]

    def attr_plane(vals):  # vals [T, 3] per-corner
        return (
            jnp.sum(vals * lamA, axis=1),
            jnp.sum(vals * lamB, axis=1),
            jnp.sum(vals * lamC, axis=1),
        )

    zA, zB, zC = attr_plane(sz)
    wA, wB, wC = attr_plane(inv_w)
    uwA, uwB, uwC = attr_plane(uv[..., 0] * inv_w)
    vwA, vwB, vwC = attr_plane(uv[..., 1] * inv_w)

    # Tile-grid bbox, clamped to the scissor rect.
    sx0f = jnp.min(sx, axis=1)
    sx1f = jnp.max(sx, axis=1)
    sy0f = jnp.min(sy, axis=1)
    sy1f = jnp.max(sy, axis=1)
    scx, scy, scw, sch = (scissor[i] for i in range(4))
    # Pixel ranges intersected with scissor; converted to inclusive tile coords.
    px0 = jnp.maximum(jnp.floor(sx0f - 0.5).astype(jnp.int32), scx)
    px1 = jnp.minimum(jnp.ceil(sx1f - 0.5).astype(jnp.int32), scx + scw - 1)
    py0 = jnp.maximum(jnp.floor(sy0f - 0.5).astype(jnp.int32), scy)
    py1 = jnp.minimum(jnp.ceil(sy1f - 0.5).astype(jnp.int32), scy + sch - 1)
    tx0 = jnp.clip(px0 // tile_w, 0, grid_w - 1)
    tx1 = jnp.clip(px1 // tile_w, 0, grid_w - 1)
    ty0 = jnp.clip((py0 - row0) // tile_h, 0, grid_h - 1)
    ty1 = jnp.clip((py1 - row0) // tile_h, 0, grid_h - 1)
    on_screen = (px0 <= px1) & (py0 <= py1)

    valid = tri_valid & in_front & nondegenerate & on_screen
    keep = cull_keep_mask(area2, cull_mode, front_face)
    if keep is not None:
        valid = valid & keep

    # stack in channel order (scatter-free); columns must follow the CH_*
    # layout above
    channels = jnp.stack([
        eA[:, 0], eB[:, 0], eC[:, 0],          # CH_E0
        eA[:, 1], eB[:, 1], eC[:, 1],          # CH_E1
        area2 * sgn, jnp.zeros_like(area2),    # CH_TWOA: |2A| (e2 derived)
        jnp.zeros_like(area2),
        zA, zB, zC,                            # CH_Z
        wA, wB, wC,                            # CH_INVW
        uwA, uwB, uwC,                         # CH_UW
        vwA, vwB, vwC,                         # CH_VW
        meta_pack(tex_id, topleft),            # CH_META
        order,                                 # CH_ORDER
        # eval-domain bound: kernels evaluate the z plane at every pixel of
        # covered tiles, which live inside viewport extent + one tile of
        # padding (tiles are <= 128 px in either axis)
        _zmin_quantized(sz, zA, zB, zC,        # CH_ZMIN
                        jnp.abs(viewport[0]) + viewport[2] + 128.0,
                        jnp.abs(viewport[1]) + viewport[3] + 128.0),
    ], axis=1)
    assert channels.shape[1] == NUM_CHANNELS

    return TriangleSetup(
        valid=valid,
        channels=channels,
        tile_lo=jnp.stack([tx0, ty0], axis=1),
        tile_hi=jnp.stack([tx1, ty1], axis=1),
        lam=jnp.stack([lamA, lamB, lamC], axis=2),
    )


@functools.partial(jax.jit, static_argnames=("tri_capacity",))
def build_triangle_table(positions, uvs, normals, indices, first_index,
                         vertex_offset, tri_base, tri_count, *,
                         tri_capacity: int):
    """Materialize the per-triangle corner table for a draw list.

    Geometry and topology are static between scene edits (the reference's
    bindless arenas + per-frame matrices, ref: mesh_renderer.rs:52-78), so
    the expensive corner gathers run once per draw-list change and the
    per-frame vertex stage (transform_corner_table) is pure matrix math.

    Returns (corner f32 [Tcap, 3, 8] = pos+uv+normal per corner,
    draw i32 [Tcap], valid bool [Tcap]).
    """
    D = first_index.shape[0]
    I = indices.shape[0]
    Tcap = tri_capacity

    t = jnp.arange(Tcap, dtype=jnp.int32)
    draw = jnp.clip(
        jnp.searchsorted(tri_base, t, side="right") - 1, 0, D - 1
    ).astype(jnp.int32)
    local = t - tri_base[draw]
    in_draw = (local >= 0) & (local < tri_count[draw])

    i3 = (I // 3) * 3
    ipos = first_index[draw] + 3 * local
    ipos = jnp.clip(ipos, 0, max(i3 - 3, 0))
    idx = indices.astype(jnp.int32)[:i3].reshape(-1, 3)[ipos // 3]  # [T, 3]
    vtx = jnp.clip(idx + vertex_offset[draw][:, None], 0, positions.shape[0] - 1)
    verts8 = jnp.concatenate([positions, uvs, normals], axis=1)   # [V, 8]
    corner = verts8[vtx]                                 # [T, 3, 8] row gathers
    return corner, draw, in_draw


def transform_corner_table(corner, draw, mvps):
    """Per-frame vertex stage over a cached triangle table: gather-free.

    corner f32 [T, 3, 5+] (pos+uv, optionally +normal), draw i32 [T],
    mvps f32 [D, 4, 4].  Returns (clip [T, 3, 4], uv [T, 3, 2]).
    """
    T = corner.shape[0]
    D = mvps.shape[0]
    corner_pos = corner[..., :3]
    corner_uv = corner[..., 3:5]
    ones = jnp.ones(corner_pos.shape[:-1] + (1,), corner_pos.dtype)
    h = jnp.concatenate([corner_pos, ones], axis=-1)  # [T, 3, 4]
    if D <= 64:
        onehot = (draw[:, None] == jnp.arange(D, dtype=jnp.int32)[None, :]).astype(
            jnp.float32
        )
        tri_mvp = jnp.dot(
            onehot, mvps.reshape(D, 16), precision=jax.lax.Precision.HIGHEST
        ).reshape(T, 4, 4)
    else:
        tri_mvp = mvps[draw]
    # broadcast-multiply + reduce instead of a T-batched einsum of tiny
    # 4x4x3 matmuls; the reduction over 4 stays exact f32
    clip = jnp.sum(tri_mvp[:, None, :, :] * h[:, :, None, :], axis=-1)
    return clip, corner_uv


def transform_mesh_corners(positions, uvs, indices, first_index, vertex_offset,
                           tri_base, tri_count, mvps, tri_capacity: int):
    """Assemble per-triangle clip corners + uvs for a padded draw list.

    positions f32[V, 3], uvs f32[V, 2], indices i32[I] — the geometry arenas
    (the bindless vertex/index buffer analog, ref:
    src/resource/resource_allocator.rs:15-16).
    first_index/vertex_offset i32[D] + mvps f32[D, 4, 4] — the draw list
    (cmd_draw_indexed args, ref: src/render_objects/mesh_renderer.rs:72-78).
    tri_base/tri_count i32[D]: host-computed prefix table assigning each draw
    a contiguous range of the flat triangle id space — supports many draws
    instancing the *same* index range with different model matrices.
    tri_capacity: static number of triangle slots (>= sum of tri_count).

    Returns (clip [Tcap,3,4], uv [Tcap,3,2], tri_draw i32[Tcap],
    tri_valid bool[Tcap]).  Equivalent to build_triangle_table +
    transform_corner_table; production code caches the table across frames
    (rendering/forward.py) and only runs the transform per frame.
    """
    corner, draw, in_draw = build_triangle_table(
        positions, uvs, jnp.zeros_like(positions), indices, first_index,
        vertex_offset, tri_base, tri_count, tri_capacity=tri_capacity,
    )
    clip, corner_uv = transform_corner_table(corner, draw, mvps)
    return clip, corner_uv, draw, in_draw
