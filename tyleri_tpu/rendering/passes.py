"""Render-pass building blocks: the mesh pass and UI pass as jittable
functions over framebuffer state.

This is the kernel-orchestration layer under ForwardRenderingFunction — the
analog of the reference's render-pass recording (begin render pass, record
draws, end — ref: src/rendering_function/forward_rendering/mod.rs:262-324),
except "recording" is tracing into one XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tyleri_tpu.ops import raster_pallas
from tyleri_tpu.ops.binning import bin_triangles
from tyleri_tpu.ops.clip import near_clip_triangles
from tyleri_tpu.ops.raster_exact import rasterize_exact
from tyleri_tpu.ops.setup import setup_triangles
from tyleri_tpu.ops.shade import shade_visibility
from tyleri_tpu.ops.visibility import rasterize_visibility
from tyleri_tpu.pipeline.state import PipelineState


# Screen tile of binning and of the visibility kernel (one kernel program
# per tile): 256 pixels fill whole warps.  See PERF.md for the tile sweep.
TILE_W = 16
TILE_H = 16


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """Static capacities/shapes of the raster pipeline (hashed into jit).

    The analog of the reference's fixed buffer-size constants
    (ref: src/resource/resource_allocator.rs:15-16, render_scene.rs:20-21):
    capacities are plan parameters, overflow is reported, and re-planning
    recompiles (like swapchain recreation).
    """

    fb_w: int
    fb_h: int
    tile_w: int = 8
    tile_h: int = 8
    entry_cap: int = 1 << 16
    cap_per_tile: int = 256
    max_tiles_per_tri: int = 32
    broad_cap: int = 64
    chunk: int = 32
    clip_cap: int = 256  # extra triangle slots for near-plane splits
    # capacity of binning's spill list (tiles 2.. of multi-tile triangles;
    # tile 1 is a dense slot per triangle) — occupancy-grown like entry_cap
    spill_cap: int = 1 << 16
    # learned per-spill-level cap fit (adaptive feedback; () = derive from
    # spill_cap via the tuned fractions).  The fractions fit ONE cover
    # histogram; when a scene's histogram differs, level truncation
    # triggers the global spill_cap doubling and the emitted row budget
    # balloons (sponza: 2.8M emitted rows for 1.19M live entries) — the
    # fit caps each level at ~1.25x its observed triangle-prefix demand
    spill_level_caps: tuple = ()
    # dense (first-tile) slots for LIVE narrow triangles: binning compacts
    # culled/invalid rows past this bound so they stop riding the big
    # expansion sort and the channel gather (0 = one slot per setup row)
    valid_cap: int = 0
    exact: bool = False  # ordered per-fragment blending (slow, parity mode)
    # visibility backend (visibility_backend): "auto" = the compiled
    # kernel on a GPU, the XLA path elsewhere; True = the kernel (compiled
    # on a GPU, interpreted on the CPU, for tests); False = the XLA path
    pallas: object = "auto"
    # two-layer depth peel (kernel path): the kernel carries the top-2
    # (z, order) fragments per pixel and the deferred shade applies the
    # blend equation over layer2-then-layer1 — per-fragment sequential
    # blending (ref common_pipeline.rs:117-131) to within the third
    # layer's contribution, which the SrcColor/OneMinusDstColor mesh
    # blend damps geometrically (validate: tools/measure_blend_deviation)
    peel2: bool = False
    # sampler anisotropy (builders.rs:300-320 max_sampler_anisotropy): >1
    # engages footprint-filtered sampling in the deferred shade with this
    # many bilinear taps along the footprint's major axis.  Set from
    # RenderDevice.sampler_anisotropy; 0/1 = plain bilinear (the default
    # sampler).  Applies to the visibility paths; exact mode keeps the
    # per-triangle bilinear fragment loop.
    aniso_taps: int = 0

    @property
    def grid_w(self) -> int:
        return _cdiv(self.fb_w, self.tile_w)

    @property
    def grid_h(self) -> int:
        return _cdiv(self.fb_h, self.tile_h)

    @staticmethod
    def for_scene(fb_w: int, fb_h: int, tri_capacity: int, **kw) -> "RasterPlan":
        """Heuristic capacities: ~2 tiles per small triangle on average.
        The tile shape is chosen here, once, for every backend: binning's
        tile grid must equal the visibility kernel's tile."""
        entry_cap = max(1024, 2 * tri_capacity)
        cap_per_tile = max(128, min(4096, entry_cap // 8))
        kw.setdefault("tile_w", TILE_W)
        kw.setdefault("tile_h", TILE_H)
        return RasterPlan(
            fb_w=fb_w, fb_h=fb_h, entry_cap=entry_cap,
            cap_per_tile=cap_per_tile, **kw,
        )


def visibility_backend(plan: RasterPlan, state: PipelineState) -> str:
    """The one backend decision for the visibility resolve:

    * "kernel"    — the compiled Triton-route kernel (ops/raster_pallas.py);
                    every GPU frame whose pipeline state the kernel covers
    * "interpret" — the same kernel through the Pallas interpreter; only
                    when ``plan.pallas is True`` off the GPU (CPU tests)
    * "xla"       — ops/visibility.py: the CPU default, ``pallas=False``,
                    and depth states outside the kernel's envelope

    A GPU never interprets: there the kernel compiles or the frame fails."""
    supported = raster_pallas.kernel_supports(
        plan.tile_w, plan.tile_h, state.depth)
    if plan.pallas is True and not supported:
        raise ValueError(
            "RasterPlan.pallas=True but the plan/pipeline-state is outside "
            "the visibility kernel (needs power-of-two tile sides and depth "
            "test+write with LESS/LESS_OR_EQUAL)")
    if plan.pallas is False or not supported:
        return "xla"
    if jax.default_backend() == "gpu":
        return "kernel"
    return "interpret" if plan.pallas is True else "xla"


class PassStats(NamedTuple):
    """Per-pass validation counters (consumed by the validation layer)."""

    bin_overflow: jax.Array   # i32 [] entries dropped in binning
    tile_overflow: jax.Array  # i32 [] entries beyond per-tile capacity
    clip_overflow: jax.Array  # i32 [] near-plane crossings beyond clip_cap
    clip_crossings: jax.Array = None  # i32 [] total crossings observed
                                      # (adaptive clip-skip feedback)
    bin_demand: jax.Array = None  # i32 [] live narrow triangles (dense-slot
                                  # demand, pre-cap) — drives the one-time
                                  # valid_cap shrink in the frame feedback
    entry_demand: jax.Array = None  # i32 [] live placed entries (dense +
                                    # spill, post-sort) — drives the
                                    # adaptive entry-slice shrink: binning's
                                    # (tile, zmin) sort keeps dead rows
                                    # last, so entry_cap can slice well
                                    # below the emitted row budget once the
                                    # live demand is known (the gather and
                                    # table write are latency/BW-bound per
                                    # STATIC row: ~37% of cap rows were
                                    # dead on sponza)
    spill_demand: jax.Array = None  # i32 [L] per-spill-level triangle
                                    # demand (adaptive spill_level_caps
                                    # fit feedback)


def mesh_pass(
    plan: RasterPlan,
    state: PipelineState,
    color,       # f32 [H, W, 4]
    depth,       # f32 [H, W]
    clip,        # f32 [T, 3, 4]
    uv,          # f32 [T, 3, 2]
    tex_id,      # i32 [T]
    tri_valid,   # bool [T]
    viewport,    # f32 [6]
    scissor,     # i32 [4]
    texels, tex_offset, tex_width, tex_height,
    normals=None,     # f32 [T, 3, 3] world-space corner normals (lit path)
    lit_params=None,  # (light [12], inv_vp [4, 4], eye [3]) (lit path)
    row0=0,           # i32 [] frame row of the framebuffer's first row: a
                      # band of a sharded frame keeps frame coordinates
                      # (viewport, scissor), so its planes are bit-equal to
                      # the whole frame's (exact mode takes band-local
                      # coordinates instead)
):
    """Draw a batch of mesh triangles.

    Returns (color, depth, PassStats, order_map) — order_map is the
    per-pixel draw order of this pass's winner (-1 where the pass wrote
    nothing; None in exact mode, which has no visibility buffer)."""
    lit = normals is not None and lit_params is not None
    if lit and plan.exact:
        raise NotImplementedError(
            "lit shading is a visibility-path feature; exact mode renders "
            "unlit (the reference's fragment path)"
        )
    # normals ride the uv slot through the clip pass (its rotate/lerp
    # machinery is shape-agnostic on the attribute dim)
    attrs = jnp.concatenate([uv, normals], axis=-1) if lit else uv
    ct = near_clip_triangles(
        clip, attrs, tex_id, tri_valid, extra_cap=plan.clip_cap)
    ct_uv = ct.uv[..., :2] if lit else ct.uv

    if plan.exact:
        color, depth = rasterize_exact(
            color, depth, ct.clip, ct_uv, ct.tex_id, ct.valid, viewport, scissor,
            texels, tex_offset, tex_width, tex_height, state=state,
            order=ct.order,
        )
        zero = jnp.zeros((), jnp.int32)
        return (color, depth,
                PassStats(zero, zero, ct.overflow, ct.crossings, zero, zero),
                None)

    su = setup_triangles(
        ct.clip, ct_uv, ct.tex_id, ct.valid, viewport, scissor,
        tile_w=plan.tile_w, tile_h=plan.tile_h,
        grid_w=plan.grid_w, grid_h=plan.grid_h,
        order=ct.order,
        cull_mode=state.raster.cull_mode,
        front_face=state.raster.front_face,
        row0=row0,
    )
    extra = None
    if lit:
        # world-normal/w interpolation planes per (post-clip) triangle:
        # plane-evaluating (n_k * 1/w) then multiplying by w per pixel is
        # the perspective-correct normal interpolation (Vulkan 27.7)
        import jax

        w = ct.clip[..., 3]
        iw = jnp.where(jnp.abs(w) > 1e-12, 1.0 / w, 0.0)   # [Tct, 3]
        nw_iw = ct.uv[..., 2:5] * iw[..., None]            # [Tct, 3, 3]
        planes = jnp.einsum("tik,tic->tkc", nw_iw, su.lam,
                            precision=jax.lax.Precision.HIGHEST)
        extra = jnp.pad(planes.reshape(planes.shape[0], 9), ((0, 0), (0, 3)))
    return _raster_binned(plan, state, color, depth, su, viewport, scissor,
                          texels, tex_offset, tex_width, tex_height,
                          clip_overflow=ct.overflow,
                          clip_crossings=ct.crossings,
                          extra=extra, lit_params=lit_params, row0=row0)


def _raster_binned(
    plan: RasterPlan,
    state: PipelineState,
    color, depth,
    su,          # TriangleSetup
    viewport, scissor,
    texels, tex_offset, tex_width, tex_height,
    *,
    clip_overflow, clip_crossings,
    extra=None, lit_params=None, row0=0,
):
    backend = visibility_backend(plan, state)
    peel2 = bool(plan.peel2) and backend != "xla"
    binned = bin_triangles(
        su, extra,
        grid_w=plan.grid_w, grid_h=plan.grid_h,
        entry_cap=plan.entry_cap,
        max_tiles_per_tri=plan.max_tiles_per_tri,
        broad_cap=plan.broad_cap,
        spill_cap=plan.spill_cap,
        valid_cap=plan.valid_cap,
        spill_level_caps=plan.spill_level_caps,
    )
    vis2 = None
    if backend == "xla":
        vis, tile_overflow = rasterize_visibility(
            binned, depth, scissor, row0=row0,
            fb_w=plan.fb_w, fb_h=plan.fb_h,
            tile_w=plan.tile_w, tile_h=plan.tile_h,
            grid_w=plan.grid_w, grid_h=plan.grid_h,
            cap_per_tile=plan.cap_per_tile, chunk=plan.chunk,
            depth_state=state.depth,
        )
    else:
        out = raster_pallas.rasterize_visibility_pallas(
            binned, depth, scissor, row0,
            fb_w=plan.fb_w, fb_h=plan.fb_h,
            tile_w=plan.tile_w, tile_h=plan.tile_h,
            grid_w=plan.grid_w, grid_h=plan.grid_h,
            chunk=plan.chunk,
            depth_state=state.depth,
            interpret=backend == "interpret",
            peel2=peel2,
        )
        if peel2:
            vis, vis2, tile_overflow = out
        else:
            vis, tile_overflow = out
    lit = None
    if extra is not None and lit_params is not None:
        light, inv_vp, eye = lit_params
        combined = jnp.concatenate([binned.entry_extra, binned.broad_extra])
        lit = (combined, light, inv_vp, eye, viewport)
    if vis2 is not None:
        # sequential-blend recovery: the deeper layer blends into the
        # incoming framebuffer first, then the visible layer over it —
        # the last two steps of the true per-fragment blend chain
        color = shade_visibility(
            vis2, texels, tex_offset, tex_width, tex_height, state.blend,
            color, lit=lit, aniso_taps=plan.aniso_taps, row0=row0,
        )
    color = shade_visibility(
        vis, texels, tex_offset, tex_width, tex_height, state.blend, color,
        lit=lit, aniso_taps=plan.aniso_taps, row0=row0,
    )
    depth = vis.depth if state.depth.write_enable else depth
    pass_order = jnp.where(vis.owner >= 0, vis.order, -1.0)
    return (color, depth,
            PassStats(binned.overflow, tile_overflow, clip_overflow,
                      clip_crossings, binned.dense_demand,
                      binned.num_entries, binned.level_demand),
            pass_order)


def ui_pass(
    state: PipelineState,
    color, depth,
    ui_clip,      # f32 [T, 3, 4] (built from point coords by the UI "shader")
    ui_uv,        # f32 [T, 3, 2]
    ui_color,     # f32 [T, 3, 4] per-corner vertex colors
    ui_tex,       # i32 [T]
    ui_valid,     # bool [T]
    viewport, scissor,
    texels, tex_offset, tex_width, tex_height,
):
    """UI overlay pass: ordered exact rasterization with vertex colors.

    Matches the reference quirk of recording UI before any meshes with depth
    test+write enabled at z = 0 (ref: forward_rendering/mod.rs:291-296,
    ui.vert:16-18) — UI pixels occlude mesh fragments behind them.

    Empty-overlay skipping is STATIC: the caller gates this pass on
    FramePlan.has_ui (host-known per frame).  A traced lax.cond here would
    risk being flattened to a select by XLA, paying the full padded scan
    every frame (the reference early-outs host-side too, stages.rs:39-45).
    """
    return rasterize_exact(
        color, depth, ui_clip, ui_uv, ui_tex, ui_valid, viewport, scissor,
        texels, tex_offset, tex_width, tex_height,
        state=state, with_vertex_color=True, vertex_color=ui_color,
        # UI quads are small; per-window bilinear taps dominate the cost
        # and scale with window area, so keep windows tight
        window=64,
    )


def ui_points_to_clip(ui_pos_points, screen_size_points):
    """UI vertex shader (ref: src/pipeline/glsl/ui.vert:16-18):
    clip = (2*p/screen_size - 1, 0, 1). ui_pos_points [..., 2] -> [..., 4]."""
    p = jnp.asarray(ui_pos_points, jnp.float32)
    sw = screen_size_points[0]
    sh = screen_size_points[1]
    x = 2.0 * p[..., 0] / sw - 1.0
    y = 2.0 * p[..., 1] / sh - 1.0
    z = jnp.zeros_like(x)
    w = jnp.ones_like(x)
    return jnp.stack([x, y, z, w], axis=-1)
