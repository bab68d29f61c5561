"""ForwardRenderingFunction — the forward render path
(ref: src/rendering_function/forward_rendering/mod.rs).

The reference records, per frame: begin render pass (clear color [0,0,0,0],
clear depth 1.0 — mod.rs:218-229), UI into the first secondary command
buffer (mod.rs:291-296), then per camera the mesh draws fanned over rayon
threads (mod.rs:297-313).  The frame program is one jitted
function: clear -> UI pass (exact, ordered) -> per-camera mesh pass
(visibility raster + deferred shade), compiled per (resolution, capacities,
pipeline states) — capacities auto-grow in powers of two, which recompiles,
exactly like swapchain/pipeline recreation.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from tyleri_tpu.device import debug
from tyleri_tpu.ops.setup import build_triangle_table, transform_corner_table
from tyleri_tpu.pipeline.common_pipeline import CommonPipeline
from tyleri_tpu.pipeline.state import PipelineState
from tyleri_tpu.pipeline.ui_pipeline import UIPipeline
from tyleri_tpu.rendering.function import Frame
from tyleri_tpu.rendering.passes import (
    RasterPlan, mesh_pass, ui_pass, visibility_backend)

# Shared by every ForwardRenderingFunction instance: concurrent first
# compiles from separate instances (one per window) race jax's persistent
# compile-cache writer and can segfault — see the _record_lock comment in
# __init__.  RLock so resize()/note_overflow() may nest inside record paths.
_GLOBAL_RECORD_LOCK = threading.RLock()

CLEAR_COLOR = (0.0, 0.0, 0.0, 0.0)  # ref: mod.rs:218-223
CLEAR_DEPTH = 1.0                   # ref: mod.rs:224-229


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _cap_growth(n: int, granule: int, floor: int) -> int:
    """Monotone capacity growth: pow2 below `granule` (small scenes stay
    small), then `granule`-sized steps (pow2 would overshoot the big
    per-entry arrays by up to 2x, costing real milliseconds per frame)."""
    if n <= granule:
        return _next_pow2(n, floor)
    return max(floor, -(-n // granule) * granule)


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Static capacities of one compiled frame program."""

    raster: RasterPlan
    cam_cap: int = 1
    draw_cap: int = 16
    tri_cap: int = 1 << 12
    ui_tri_cap: int = 256
    # Host-known per-frame fact, not a capacity: whether any UI triangle is
    # live.  A traced `lax.cond` may be flattened to a select by XLA (both
    # branches execute), so an empty overlay must be skipped statically —
    # toggling recompiles, like the reference rebuilding command buffers.
    has_ui: bool = True
    # Blinn-Phong lighting (any camera has a DirectionalLight).  Static for
    # the same reason as has_ui; the unlit frame pays nothing for it.
    lit: bool = False
    # Presentation quantize fused into the frame program: None (no u8
    # output — direct API users), "opaque" (CompositeAlpha::OPAQUE,
    # swapchain.rs:59: alpha forced 255) or "inherit".  Fusing saves one
    # executable launch per frame.
    present_u8: "str | None" = None


def quantize_unorm8(color, opaque: bool):
    """On-device UNORM8 presentation store (round-to-nearest): presenting
    fetches 1/4 of the bytes, and the display ignores alpha under OPAQUE
    (the mesh pipeline writes alpha 0 — without forcing 255 the presented
    PNGs read as transparent in viewers)."""
    u8 = jnp.clip(jnp.round(color * 255.0), 0, 255).astype(jnp.uint8)
    if opaque:
        u8 = u8.at[..., 3].set(jnp.uint8(255))
    return u8


def _shift_viewport(viewport, y0):
    """Shift a viewport down-screen by y0 pixels (band-local coordinates)."""
    return viewport.at[1].add(-y0.astype(jnp.float32))


def _shift_scissor(scissor, y0, band_h: int):
    """Intersect a scissor rect with the band [y0, y0+band_h) and express it
    in band-local coordinates."""
    band = _band_scissor(scissor, y0, band_h)
    return band.at[1].add(-y0.astype(jnp.int32))


def _band_scissor(scissor, y0, band_h: int):
    """Intersect a scissor rect with the band [y0, y0+band_h), in frame
    coordinates."""
    sy0 = jnp.clip(scissor[1], y0, y0 + band_h)
    sy1 = jnp.clip(scissor[1] + scissor[3], y0, y0 + band_h)
    return jnp.stack([scissor[0], sy0, scissor[2], sy1 - sy0]).astype(jnp.int32)


def frame_body(
    plan: FramePlan,
    mesh_state: PipelineState,
    ui_state: PipelineState,
    texels, tex_offset, tex_width, tex_height,
    clear_color,     # f32 [4]
    cam_valid,       # bool [C]
    viewports,       # f32 [C, 6]
    scissors,        # i32 [C, 4]
    view_projs,      # f32 [C, 4, 4] (projection @ view)
    models,          # f32 [C, D, 4, 4]
    corners,         # f32 [C, T, 3, 5] cached triangle tables (pos+uv)
    tri_draw,        # i32 [C, T]
    tri_valid0,      # bool [C, T]
    tri_tex,         # i32 [C, T]
    lights,          # f32 [C, 12] packed DirectionalLight uniforms
    inv_vps,         # f32 [C, 4, 4] inverse view-projections (lit unproject)
    eyes,            # f32 [C, 3] camera world positions
    ui_clip, ui_uv, ui_color, ui_tex, ui_valid,                 # [U, 3, ...]
    window_viewport, window_scissor,
    *,
    band_y0=None,     # traced scalar pixel offset of this band (sharded mode)
    draw_mod=None,    # (n, i) traced pair: keep draws with id % n == i
                      # (sharded ParallelGroup round-robin)
):
    """One frame (or one band of a frame): clear -> UI -> per-camera meshes.

    ``plan.raster.fb_h`` is the height actually rasterized; in sharded mode
    it is the band height and ``band_y0`` shifts all viewports/scissors into
    band-local coordinates.
    """
    H, W = plan.raster.fb_h, plan.raster.fb_w
    color = jnp.broadcast_to(clear_color, (H, W, 4)).astype(jnp.float32)
    depth = jnp.full((H, W), CLEAR_DEPTH, jnp.float32)
    # global draw order of each pixel's winner: -1 clear, 0 UI, >=1 meshes
    # (camera-major; later camera passes overwrite equal-depth fragments)
    order = jnp.full((H, W), -1.0, jnp.float32)

    y0 = jnp.zeros((), jnp.int32) if band_y0 is None else band_y0
    wvp = _shift_viewport(window_viewport, y0)
    wsc = _shift_scissor(window_scissor, y0, H)

    # UI records first (ref: mod.rs:291-296) — with depth write at z=0 it
    # occludes mesh fragments behind it.  Skipped statically when the frame
    # has no UI (plan.has_ui is host-known per frame).
    if plan.has_ui:
        color, depth = ui_pass(
            ui_state, color, depth, ui_clip, ui_uv, ui_color, ui_tex, ui_valid,
            wvp, wsc, texels, tex_offset, tex_width, tex_height,
        )
        order = jnp.where(depth < CLEAR_DEPTH, 0.0, order)

    # camera-pass order stride: per-pass order values are triangle-table
    # slots in [0, tri_cap + clip extras)
    span = float(plan.tri_cap + plan.raster.clip_cap + 1)
    bin_of = jnp.zeros((), jnp.int32)
    tile_of = jnp.zeros((), jnp.int32)
    clip_of = jnp.zeros((), jnp.int32)
    clip_x = jnp.zeros((), jnp.int32)
    bin_dem = jnp.zeros((), jnp.int32)
    entry_dem = jnp.zeros((), jnp.int32)
    spill_dem = None
    for c in range(plan.cam_cap):
        mvps = jnp.einsum(
            "ij,djk->dik", view_projs[c], models[c],
            precision=jax.lax.Precision.HIGHEST,
        )
        # gather-free per-frame vertex stage over the cached table
        clip, uv3 = transform_corner_table(corners[c], tri_draw[c], mvps)
        tex_ids = tri_tex[c]
        tvalid = tri_valid0[c] & cam_valid[c]
        if draw_mod is not None:
            # round-robin draw sharding without a gather: draw id mod n
            tvalid = tvalid & ((tri_draw[c] % draw_mod[0]) == draw_mod[1])
        normals = lit_params = None
        if plan.lit:
            # world-space corner normals: per-draw inverse-transpose
            # model rotation, selected per triangle via the same
            # one-hot pattern as the MVPs (exact 0/1 weights)
            D = plan.draw_cap
            nm = jnp.transpose(
                jnp.linalg.inv(models[c][:, :3, :3]), (0, 2, 1)
            )
            onehot = (
                tri_draw[c][:, None] == jnp.arange(D, dtype=jnp.int32)
            ).astype(jnp.float32)
            tri_nm = jnp.dot(
                onehot, nm.reshape(D, 9),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(-1, 3, 3)
            corner_nrm = corners[c][..., 5:8]
            normals = jnp.einsum(
                "tck,tjk->tcj", corner_nrm, tri_nm,
                precision=jax.lax.Precision.HIGHEST,
            )
            lit_params = (lights[c], inv_vps[c], eyes[c])
        if plan.raster.exact:
            # exact mode rasterizes in band-local coordinates
            vp, sc, row0 = (_shift_viewport(viewports[c], y0),
                            _shift_scissor(scissors[c], y0, H), 0)
        else:
            # the visibility path keeps frame coordinates, so a band's
            # planes and pixels are bit-equal to the whole frame's
            vp, sc, row0 = viewports[c], _band_scissor(scissors[c], y0, H), y0
        color, depth, st, pass_order = mesh_pass(
            plan.raster, mesh_state, color, depth,
            clip, uv3, tex_ids, tvalid, vp, sc,
            texels, tex_offset, tex_width, tex_height,
            normals=normals, lit_params=lit_params, row0=row0,
        )
        if pass_order is not None:
            order = jnp.where(
                pass_order >= 0.0, c * span + pass_order + 1.0, order
            )
        bin_of = bin_of + st.bin_overflow
        tile_of = tile_of + st.tile_overflow
        clip_of = clip_of + st.clip_overflow
        clip_x = clip_x + st.clip_crossings
        if st.bin_demand is not None:
            bin_dem = jnp.maximum(bin_dem, st.bin_demand)
        if st.entry_demand is not None:
            entry_dem = jnp.maximum(entry_dem, st.entry_demand)
        if st.spill_demand is not None:
            spill_dem = (st.spill_demand if spill_dem is None
                         else jnp.maximum(spill_dem, st.spill_demand))

    return Frame(color=color, depth=depth, bin_overflow=bin_of,
                 tile_overflow=tile_of, order=order, clip_overflow=clip_of,
                 clip_crossings=clip_x, bin_demand=bin_dem,
                 entry_demand=entry_dem, spill_demand=spill_dem)


def _pack_host_arrays(arrays):
    """Pack every host numpy leaf of the frame-input tuple into ONE u8
    blob so record() ships a single host->device transfer per frame
    instead of one per leaf (~15 small leaves, ~35 KB in all).
    Device-resident leaves (texture/triangle tables) pass through.
    Returns (device_leaves, spec, blob): ``spec`` is the static unpack
    layout ((index, dtype, shape) per packed leaf, hashable)."""
    spec = []
    chunks = []
    device_leaves = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            spec.append((i, a.dtype.str, a.shape))
            chunks.append(np.ascontiguousarray(a).view(np.uint8).ravel())
        else:
            device_leaves.append(a)
    blob = (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.uint8))
    return tuple(device_leaves), tuple(spec), blob


def _unpack_host_arrays(spec, blob, device_leaves, total):
    """Device-side inverse of _pack_host_arrays: static slices + bitcasts
    (free under XLA fusion) rebuild the original frame-input tuple."""
    vals = [None] * total
    off = 0
    for i, dstr, shape in spec:
        dt = np.dtype(dstr)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        piece = blob[off:off + n]
        off += n
        if dt == np.bool_:
            arr = (piece != 0).reshape(shape)
        elif dt.itemsize == 1:
            arr = piece.astype(dt).reshape(shape)
        else:
            arr = jax.lax.bitcast_convert_type(
                piece.reshape((n // dt.itemsize, dt.itemsize)), dt
            ).reshape(shape)
        vals[i] = arr
    it = iter(device_leaves)
    for i in range(total):
        if vals[i] is None:
            vals[i] = next(it)
    return vals


@functools.partial(jax.jit, static_argnames=(
    "plan", "mesh_state", "ui_state", "spec", "total"))
def _render_frame_packed(plan, mesh_state, ui_state, spec, total, blob,
                         *device_leaves):
    arrays = _unpack_host_arrays(spec, blob, device_leaves, total)
    frame = frame_body(plan, mesh_state, ui_state, *arrays)
    if plan.present_u8 is not None:
        frame = frame._replace(color_u8=quantize_unorm8(
            frame.color, opaque=plan.present_u8 == "opaque"))
    return frame


@functools.partial(jax.jit, static_argnames=("plan", "mesh_state", "ui_state"))
def _render_frame(plan, mesh_state, ui_state, *arrays):
    frame = frame_body(plan, mesh_state, ui_state, *arrays)
    if plan.present_u8 is not None:
        frame = frame._replace(color_u8=quantize_unorm8(
            frame.color, opaque=plan.present_u8 == "opaque"))
    return frame


@functools.partial(jax.jit, static_argnames=("opaque",))
def _quantize_sharded(color, opaque: bool):
    """Separate-launch quantize for the sharded record path (its frame
    program returns a flat tuple; the extra launch is amortized by the
    per-band work)."""
    return quantize_unorm8(color, opaque=opaque)


@functools.partial(jax.jit, static_argnames=("tri_capacity",))
def _build_table(positions, uvs, normals, indices, first_index,
                 vertex_offset, tri_base, tri_count, draw_tex, *,
                 tri_capacity: int):
    corner, draw, valid = build_triangle_table(
        positions, uvs, normals, indices, first_index, vertex_offset,
        tri_base, tri_count, tri_capacity=tri_capacity,
    )
    return corner, draw, valid, draw_tex[draw]


# blend-parity auto policy (VERDICT r4 item 3): the reference's mesh
# pipeline ALWAYS blends in submission order (common_pipeline.rs:117-131),
# while the visibility path blends only the final survivor.  Below this
# triangle count the two-layer depth peel engages by default; above it the
# fast path ships and the messenger reports the deviation instead.  The
# threshold was chosen on the previous accelerator and is to be re-derived
# on the GPU from a measured peel2 cost (ROADMAP S5).
BLEND_PARITY_PEEL2_MAX_TRIS = 1 << 18


class ForwardRenderingFunction:
    """The only RenderingFunction impl, as in the reference (mod.rs:46-50)."""

    def __init__(self, render_device, swapchain, *, exact: bool = False,
                 blend_parity: str = "auto"):
        self.render_device = render_device
        w, h = swapchain.resolution
        self.common_pipeline = CommonPipeline()
        self.ui_pipeline = UIPipeline()
        # honor the device's configured depth format (the reference
        # hard-codes D16 in the render pass even when configured otherwise —
        # mod.rs:132; we fix that latent inconsistency)
        ds = dataclasses.replace(
            self.common_pipeline.state.depth, format=render_device.depth_format
        )
        self.mesh_state = dataclasses.replace(self.common_pipeline.state, depth=ds)
        uds = dataclasses.replace(
            self.ui_pipeline.state.depth, format=render_device.depth_format
        )
        self.ui_state = dataclasses.replace(self.ui_pipeline.state, depth=uds)
        # blend-parity policy: "auto" engages peel2 per-frame by scene scale
        # (see _apply_blend_parity); "peel2"/"fast" pin it; "exact" is the
        # bit-parity mode (same as exact=True).  An explicit TYLERI_PEEL2
        # env overrides the policy either way.
        if blend_parity not in ("auto", "fast", "peel2", "exact"):
            raise ValueError(f"unsupported blend_parity {blend_parity!r}")
        import os as _os

        if "TYLERI_PEEL2" in _os.environ:
            blend_parity = ("peel2"
                            if _os.environ["TYLERI_PEEL2"] not in ("0", "")
                            else "fast")
        exact = exact or blend_parity == "exact"
        self.blend_parity = blend_parity
        self._blend_parity_warned = False
        raster = RasterPlan.for_scene(w, h, 1 << 12, exact=exact)
        if blend_parity == "peel2":
            raster = dataclasses.replace(raster, peel2=True)
        # the device's shared sampler (builders.rs:300-320): anisotropy > 1
        # engages the footprint-filtered deferred shade (ops/sampling.py)
        aniso = getattr(render_device, "sampler_anisotropy", None)
        if aniso and float(aniso) > 1.0 and not exact:
            raster = dataclasses.replace(
                raster, aniso_taps=max(2, min(int(round(float(aniso))), 16))
            )
        self.plan = FramePlan(raster=raster)
        # occupancy-aware entry capacity: start tight and grow on REPORTED
        # bin overflow (note_overflow) — binning's sort/gather cost scales
        # with the static cap, not with live entries, so a blanket 2x-tris
        # cap taxes every frame of big scenes.  Spill slots (tiles 2..n of
        # multi-tile triangles) per triangle start at 0.2; entry_cap is
        # DERIVED (tri_cap + clip_cap + spill slot rows) so binning never
        # truncates live entries.
        self._spill_headroom = 0.2
        # record() mutates host state (plan growth, triangle-table cache);
        # DispatchQueue workers may run successive records on different
        # threads, so serialize them here.  The lock is PROCESS-WIDE, not
        # per-instance: two RenderWindows sharing one device record on two
        # DispatchQueue worker threads, and concurrent FIRST compiles
        # (jit tracing in record) race jax's persistent compile-cache
        # writer (zstd, jax/_src/compilation_cache.py put_executable_and_time)
        # and segfault the process.  jax owns that thread-safety bug, but we
        # choose to compile on worker threads, so we own the workaround.
        # Post-compile the serialized section is host-side only (~ms);
        # device execution remains async and overlapped across windows.
        self._record_lock = _GLOBAL_RECORD_LOCK
        # adaptive dense-slot shrink: ~40-50% of the triangle table is
        # culled/invalid on real scenes, and binning's big sort + channel
        # gather pay for every STATIC row.  After this many overflow-free
        # frames the plan shrinks valid_cap to 1.25x the observed live
        # narrow count (1<<16 granule); any bin overflow resets it to full
        # and doubles the threshold (exponential backoff)
        self._valid_demand = 0
        self._valid_clean_frames = 0
        self._valid_shrink_after = 4
        # adaptive entry-slice shrink: the (tile, zmin) entry sort keeps
        # dead rows last, so entry_cap can slice well below the emitted
        # row budget (vbase + spill rows) once the live entry demand is
        # stable — the channel gather and its table write cost per STATIC
        # row.  Same grow/reset discipline as valid_cap: 1.25x headroom,
        # 1<<16 granule, reset + backoff on any bin overflow.
        self._entry_demand = 0
        self._entry_clean_frames = 0
        self._entry_shrink_after = 4
        self._entry_fit = 0
        # stage-2 tighten: after a LONG clean streak (tighten_mult x the
        # shrink threshold) the 1.25x fits re-fit at 1.10x — risky on
        # moving scenes, so it only engages once demand has been
        # demonstrably stable, and any overflow resets both stages with the
        # same exponential backoff.  TYLERI_TIGHTEN=0 disables.
        self._entry_tighten_mult = (
            0 if _os.environ.get("TYLERI_TIGHTEN", "1") in ("0", "")
            else 4)
        # 0 = learning, 1 = 1.25x fits applied, 2 = tightened to 1.10x.
        # One-shot transitions: re-fitting on every clean frame would
        # recompile whenever the demand max creeps up; demand growth past
        # a fit surfaces as reported overflow and resets to 0.
        self._fit_stage = 0
        # adaptive per-spill-level cap fit: the _LEVEL_FRACS fractions fit
        # one cover histogram; a mismatched scene truncates a level, the
        # conflated overflow DOUBLES spill_cap globally, and the emitted
        # row budget the big (tile, zmin) sort carries balloons.  The fit
        # caps each level at 1.25x its observed triangle-prefix demand
        # (512 granule); learned on the same clean-frame cadence as the
        # entry fit, reset together on overflow/geometry growth.
        self._spill_demand = None   # np [L] elementwise max
        self._spill_fit = ()
        # a pipeline state outside the visibility kernel's envelope routes
        # a GPU frame to the slower XLA tile path; surface it through the
        # debug messenger as a performance message
        if (not exact and jax.default_backend() == "gpu"
                and visibility_backend(self.plan.raster,
                                       self.mesh_state) == "xla"):
            render_device.debug_messenger.emit(
                debug.Severity.WARNING,
                "pallas-fallback",
                "mesh pipeline state is outside the visibility kernel's "
                "envelope (needs depth test+write with LESS/LESS_OR_EQUAL); "
                "frames will use the slower XLA tile path",
                debug.MessageType.PERFORMANCE,
            )
        # blend-order deviation reporting moved to _apply_blend_parity: the
        # "auto" policy needs the frame's triangle count to decide whether
        # peel2 engages, and the messenger should stay silent when it does.

    def resize(self, resolution) -> None:
        """Re-target the frame program to a new framebuffer size (the
        swapchain-recreation analog; the reference has no out-of-date /
        resize handling and panics — we recompile on the next record).
        Grown capacities are kept: they only ever grow, and re-learning
        them would re-pay the occupancy-growth recompiles."""
        with self._record_lock:
            w, h = resolution
            old = self.plan.raster
            # only the framebuffer dims change: tile geometry, chunking,
            # learned capacities and backend choice all carry over
            self.plan = dataclasses.replace(
                self.plan,
                raster=dataclasses.replace(old, fb_w=int(w), fb_h=int(h)),
            )

    def _apply_blend_parity(self, raster: RasterPlan, n_tris: int) -> RasterPlan:
        """Blend-parity "auto" policy (VERDICT r4 item 3, mirroring the
        present_quantize "auto" pattern): the reference blends EVERY
        overlapping mesh fragment in submission order
        (common_pipeline.rs:117-131).  Tiers by scene scale:

        * peel2 (two-layer sequential blending — exact on every pixel with
          <= 2 surviving fragments) engages below
          BLEND_PARITY_PEEL2_MAX_TRIS, where its ~20% kernel cost buys
          deviation that measurably drops (config4: 3.07% px >1u8 -> 0.34%);
        * above it the fast single-survivor path ships and the messenger
          reports the deviation once (at config5 scale peel2 still leaves
          12.7% px >1u8 — not worth 20%).

        "auto" never picks exact mode: exact drops the Frame.order map
        (cross-device z-tie arbitration) and lit shading — semantics the
        policy must not change silently.  blend_parity="exact" (or
        exact=True) remains the explicit bit-parity mode."""
        if (self.blend_parity not in ("auto", "fast") or raster.exact
                or not self.mesh_state.blend.enable):
            return raster
        want = (self.blend_parity == "auto"
                and n_tris <= BLEND_PARITY_PEEL2_MAX_TRIS)
        # peel2 is a kernel feature; where the XLA path runs (CPU,
        # unsupported depth states) the flag would be inert — keep the plan
        # stable and report the deviation instead
        effective = want and visibility_backend(
            raster, self.mesh_state) != "xla"
        if not effective and not self._blend_parity_warned:
            self._blend_parity_warned = True
            self.render_device.debug_messenger.emit(
                debug.Severity.WARNING,
                "blend-order-deviation",
                "order-dependent color blend on the visibility path: only "
                "the final visible fragment is blended; overlapping "
                "fragments that each pass the depth test would accumulate "
                "differently (peel2 adds two-layer sequential blending; "
                "exact mode gives full per-fragment parity)",
                debug.MessageType.PERFORMANCE,
            )
        if raster.peel2 != effective:
            raster = dataclasses.replace(raster, peel2=effective)
        return raster

    def _grow_plan(self, n_cams: int, n_draws: int, n_tris: int, n_ui: int) -> None:
        from tyleri_tpu.ops.binning import spill_rows

        p = self.plan
        # capacities only grow (each growth recompiles, like swapchain
        # recreation)
        tri_cap = _cap_growth(n_tris, 1 << 16, p.tri_cap)
        # spill list (tiles 2.. of multi-tile triangles): occupancy-grown
        # headroom; the multi-level expansion derives per-level caps from
        # this single bound (ops/binning.py::_level_caps)
        spill_cap = _cap_growth(
            int(self._spill_headroom * n_tris), 1 << 16, p.raster.spill_cap
        )
        # a tri_cap growth invalidates the learned dense-slot occupancy
        # (new geometry changes the live-narrow count); drop the shrink and
        # let the demand feedback re-learn it
        valid_cap = 0 if tri_cap > p.tri_cap else p.raster.valid_cap
        vbase = tri_cap + p.raster.clip_cap
        if valid_cap:
            vbase = min(valid_cap, vbase)
        srows = spill_rows(spill_cap, p.raster.max_tiles_per_tri)
        # geometry growth invalidates the learned entry-slice fit too
        if tri_cap > p.tri_cap:
            self._entry_fit = 0
            self._entry_demand = 0
            self._entry_clean_frames = 0
            self._fit_stage = 0
            self._spill_fit = ()
            self._spill_demand = None
        if self._spill_fit:
            srows = spill_rows(spill_cap, p.raster.max_tiles_per_tri,
                               self._spill_fit)
        entry_cap = vbase + srows
        if self._entry_fit:
            # binning slices the sorted entry stream at entry_cap; dead
            # rows sort last, so any live truncation is REPORTED as bin
            # overflow (which resets the fit) rather than silently dropped
            entry_cap = min(entry_cap, max(self._entry_fit, 1 << 16))
        raster = dataclasses.replace(
            p.raster,
            # every row of the expansion has a reserved slot, so the big
            # sort never truncates live entries and entry overflow reduces
            # to valid_cap / spill-level overflow (reported + grown via
            # note_overflow); tri_cap is a 1<<16 granule and spill_rows a
            # 512 granule; with a learned valid_cap the dense base shrinks to it,
            # and a learned entry-slice fit caps the whole table below the
            # emitted row budget
            entry_cap=entry_cap,
            spill_cap=spill_cap,
            valid_cap=valid_cap,
            spill_level_caps=self._spill_fit,
            # clip_cap grows only on REPORTED clip overflow (note_overflow):
            # crossing triangles are rare, and every per-triangle stage pays
            # for tri_cap + clip_cap rows
        )
        raster = self._apply_blend_parity(raster, n_tris)
        new = FramePlan(
            raster=raster,
            # exact growth, not pow2: every camera slot runs a FULL mesh
            # pass (binning + visibility) masked to nothing when dead, so a
            # 3-camera scene on a pow2 cap would pay a whole 4th raster
            # pass; cameras are few, so per-count recompiles are cheap
            cam_cap=max(n_cams, p.cam_cap),
            draw_cap=_next_pow2(n_draws, p.draw_cap),
            # granule (not pow2) growth: the whole per-triangle pipeline
            # (transform, clip scan, plane setup) is O(tri_cap), and pow2
            # overshoots by up to 2x — tens of ms at 1M triangles
            tri_cap=tri_cap,
            ui_tri_cap=_next_pow2(n_ui, p.ui_tri_cap),
            has_ui=p.has_ui,
            lit=p.lit,
            present_u8=p.present_u8,
        )
        if new != p:
            self.plan = new

    def note_overflow(self, bin_overflow: int, tile_overflow: int,
                      clip_overflow: int = 0,
                      clip_crossings: int = 0,
                      bin_demand: int = 0,
                      entry_demand: int = 0,
                      spill_demand=None,
                      n_frames: int = 1) -> None:
        """Occupancy feedback from the frame loop (RenderWindow recycle):
        a reported bin overflow grows the spill headroom so the next plan
        re-bins with more capacity (recompiles, like swapchain recreation —
        the VariableLengthBuffer.expand_to analog for the raster tables).
        A tile overflow (XLA backend's per-tile lists) doubles that cap; a
        clip overflow quadruples the near-plane split work set.

        Headroom ceiling: a narrow triangle can spill at most
        max_tiles_per_tri - 1 (31) covers, so the spill bound converges for
        any real scene well below the 6.0 cap — beyond it the overflow
        keeps being REPORTED every frame (never silently dropped) rather
        than risking an entry table tens of GB large.

        n_frames: how many frames this (aggregated) report covers — the
        window's stats drain batches N recycled frames into one call on
        the batch maxima, and the clean-streak counters driving the
        valid/entry fits count FRAMES, not drain batches, so the
        fits (and the stage-2 tighten especially) converge during a
        bench warmup's flushed batches instead of firing mid-measurement
        one drain-cadence-second at a time."""
        with self._record_lock:
            if bin_overflow > 0:
                # the counter conflates valid_cap, spill-level and
                # broad-list truncation, so grow/reset all three bounds
                # (extra capacity costs ~linearly; broad_cap is tiny;
                # entry_cap follows spill_cap + valid_cap by derivation in
                # _grow_plan).  A learned valid_cap goes back to full —
                # dense drops mean the live-narrow count rose past it.
                self._spill_headroom = min(self._spill_headroom * 2.0, 6.0)
                if self.plan.raster.valid_cap:
                    self._valid_shrink_after = min(
                        self._valid_shrink_after * 2, 512)
                self._valid_demand = 0
                self._valid_clean_frames = 0
                # a learned entry-slice fit goes back to the full emitted
                # budget — the overflow may BE the slice truncating live
                # entries (demand rose past the fit)
                if self._entry_fit or self._spill_fit:
                    self._entry_shrink_after = min(
                        self._entry_shrink_after * 2, 512)
                self._entry_fit = 0
                self._entry_demand = 0
                self._entry_clean_frames = 0
                self._fit_stage = 0
                # the overflow may be a level cap fit truncating (demand
                # rose): fall back to the fraction-derived budget, which
                # the doubled spill_cap just grew
                self._spill_fit = ()
                self._spill_demand = None
                self.plan = dataclasses.replace(
                    self.plan,
                    raster=dataclasses.replace(
                        self.plan.raster,
                        broad_cap=self.plan.raster.broad_cap * 4,
                        valid_cap=0,
                    ),
                )
            elif bin_demand > 0:
                # overflow-free frame with an observed dense-slot demand:
                # learn the live-narrow occupancy and shrink valid_cap once
                # it is stable (the shrunk plan recompiles, like any plan
                # change; _grow_plan rederives entry_cap from it)
                self._valid_demand = max(self._valid_demand, int(bin_demand))
                self._valid_clean_frames += max(1, int(n_frames))
                p = self.plan
                if (self._valid_clean_frames >= self._valid_shrink_after
                        and not p.raster.valid_cap):
                    full = p.tri_cap + p.raster.clip_cap
                    cand = -(-int(self._valid_demand * 1.25) // (1 << 16)) \
                        * (1 << 16)
                    if cand <= full - (1 << 16):
                        self.plan = dataclasses.replace(
                            p, raster=dataclasses.replace(
                                p.raster, valid_cap=cand)
                        )
            if bin_overflow <= 0 and entry_demand > 0:
                # overflow-free frame with an observed live entry count:
                # learn it and slice the sorted entry table once stable
                # (the next _grow_plan applies the fit; the shrunk plan
                # recompiles, like any plan change).  Demands from
                # OVERFLOWING frames are undercounts (truncated streams)
                # and never learned.
                self._entry_demand = max(self._entry_demand,
                                         int(entry_demand))
                if spill_demand is not None:
                    import numpy as _np

                    d = _np.asarray(spill_demand, dtype=_np.int64)
                    self._spill_demand = (
                        d if self._spill_demand is None
                        else _np.maximum(self._spill_demand, d))
                self._entry_clean_frames += max(1, int(n_frames))
                if (self._fit_stage == 0
                        and self._entry_clean_frames
                            >= self._entry_shrink_after):
                    self._fit_stage = 1
                    cand = -(-int(self._entry_demand * 1.25) // (1 << 16)) \
                        * (1 << 16)
                    if cand <= self.plan.raster.entry_cap - (1 << 16):
                        self._entry_fit = cand
                    if self._spill_demand is not None:
                        self._spill_fit = tuple(
                            max(-(-int(d * 1.25) // 512) * 512, 512)
                            for d in self._spill_demand
                        )
                elif (self._fit_stage == 1
                      and self._entry_tighten_mult
                      and self._entry_clean_frames
                          >= self._entry_tighten_mult
                          * self._entry_shrink_after):
                    # stage-2 tighten: demand has been stable for a long
                    # streak, so trade the 1.25x motion headroom for the
                    # measured ~2 ms/frame that 1.10x buys (BASELINE.md
                    # round-5 entry-cap table).  The demand maxima kept
                    # accumulating across the whole streak, so the 1.10x
                    # is over a longer observation window than the
                    # stage-1 fit used.  One recompile; live truncation
                    # would surface as reported bin overflow, resetting
                    # both stages with doubled thresholds.
                    self._fit_stage = 2
                    cand = -(-int(self._entry_demand * 1.10) // (1 << 16)) \
                        * (1 << 16)
                    if self._entry_fit and cand < self._entry_fit:
                        self._entry_fit = cand
                    if self._spill_demand is not None:
                        self._spill_fit = tuple(
                            max(-(-int(d * 1.10) // 512) * 512, 512)
                            for d in self._spill_demand
                        )
            if tile_overflow > 0:
                self.plan = dataclasses.replace(
                    self.plan,
                    raster=dataclasses.replace(
                        self.plan.raster,
                        cap_per_tile=self.plan.raster.cap_per_tile * 2,
                    ),
                )
            p = self.plan
            if clip_overflow > 0:
                # real clipping in play: grow the split work set
                new_cap = min(
                    max(p.raster.clip_cap * 4,
                        _next_pow2(p.raster.clip_cap + clip_overflow, 256)),
                    _next_pow2(p.tri_cap, 256),
                )
                self.plan = dataclasses.replace(
                    p, raster=dataclasses.replace(p.raster, clip_cap=new_cap)
                )

    def record(self, render_device, render_resources, scale_factor, window_size) -> Frame:
        """Record + submit one frame (ref: mod.rs:262-324). Returns a Frame
        of device arrays still computing (XLA async dispatch = submission)."""
        with self._record_lock:
            arrays = self.build_frame_inputs(
                render_device, render_resources, scale_factor, window_size
            )
            # ONE host->device transfer per frame: all host leaves pack
            # into a single u8 blob, unpacked device-side by static
            # slices/bitcasts inside the frame program
            device_leaves, spec, blob = _pack_host_arrays(arrays)
            blob = jax.device_put(blob)
            return _render_frame_packed(
                self.plan, self.mesh_state, self.ui_state, spec,
                len(arrays), blob, *device_leaves
            )

    def record_sharded(self, render_device, render_resources, scale_factor,
                       window_size, device_mesh) -> Frame:
        """Multi-chip record: the frame program shard_mapped over a
        (draws, tiles) device mesh (tyleri_tpu.parallel).  Draw-to-shard
        assignment is the reference's ParallelGroup round-robin
        (Camera::get_and_order_meshes, ref camera.rs:32-39) applied to the
        ``draws`` mesh axis instead of rayon threads."""
        from tyleri_tpu.parallel.mesh import AXIS_DRAWS, AXIS_TILES
        from tyleri_tpu.parallel.sharding import (
            derive_draw_groups,
            render_frame_sharded,
        )

        nd = device_mesh.shape[AXIS_DRAWS]
        if nd > 1 and self.plan.raster.peel2:
            # peel2's layer 2 is PER-PIXEL SEQUENTIAL state: the depth-record
            # holder just before the winner drew.  Partitioning pixels
            # (tiles) preserves it exactly — every pixel's full survivor
            # chain stays on one device.  Partitioning draws cannot: an
            # exact cross-shard recomposite from per-shard top-2 records is
            # unsound (a shard whose winner AND layer-2 both postdate the
            # global winner can hide the true second survivor behind its own
            # records, so the composite could blend a fragment exact mode
            # never blended — violating the survivor guarantee the kernel's
            # demotion rules exist to keep).  Policy: ONE semantics — remap
            # the mesh to tiles-only (same devices, 1 x N) and say so once.
            from jax.sharding import Mesh

            device_mesh = Mesh(
                device_mesh.devices.reshape(1, -1), (AXIS_DRAWS, AXIS_TILES)
            )
            nd = 1
            if not getattr(self, "_peel2_remap_noted", False):
                self._peel2_remap_noted = True
                render_device.debug_messenger.emit(
                    debug.Severity.INFO,
                    "peel2-mesh-tiles-only",
                    "peel2 with a draws mesh axis: re-mapped the device mesh "
                    "to tiles-only to preserve global layer-2 semantics "
                    "(draw sharding would make layer 2 shard-local; pixel "
                    "bands keep every survivor chain on one device)",
                    debug.MessageType.PERFORMANCE,
                )
        with self._record_lock:
            # production ParallelGroup partitioning (validates the
            # round-robin invariant the compiled draw%n mask relies on)
            derive_draw_groups(render_resources.cameras, nd)
            arrays = self.build_frame_inputs(
                render_device, render_resources, scale_factor, window_size
            )
            # one batched replicated upload (the same rule as record():
            # per-array transfers each pay the full host->device latency)
            arrays = jax.device_put(
                arrays,
                jax.sharding.NamedSharding(
                    device_mesh, jax.sharding.PartitionSpec()
                ),
            )
            (color, depth, order, bin_of, tile_of, clip_of,
             clip_x) = render_frame_sharded(
                self.plan, self.mesh_state, self.ui_state, device_mesh, *arrays
            )
            u8 = None
            if self.plan.present_u8 is not None:
                u8 = _quantize_sharded(
                    color, self.plan.present_u8 == "opaque")
            return Frame(color=color, depth=depth, bin_overflow=bin_of,
                         tile_overflow=tile_of, order=order,
                         clip_overflow=clip_of, clip_crossings=clip_x,
                         color_u8=u8)

    def build_frame_inputs(
        self, render_device, render_resources, scale_factor, window_size
    ):
        """Assemble the padded device-array inputs of the frame program
        (grows the plan first). Shared by the single-chip path and the
        multi-chip shard_map path (tyleri_tpu.parallel.sharding)."""
        cams = render_resources.cameras
        n_draws = max((len(c.mesh_renderers) for c in cams), default=0)
        n_tris = max(
            (
                sum(m.triangle_count for m in c.mesh_renderers)
                for c in cams
            ),
            default=0,
        )
        ui_elements = render_resources.ui
        n_ui = render_resources.ui_indices.len // 3
        self._grow_plan(max(len(cams), 1), max(n_draws, 1), max(n_tris, 1), max(n_ui, 1))
        has_ui = bool(ui_elements) and render_resources.ui_indices.len > 0
        if has_ui != self.plan.has_ui:
            self.plan = dataclasses.replace(self.plan, has_ui=has_ui)
        plan = self.plan

        alloc = render_device.memory_allocator
        texels, toff, tw, th = alloc.texture_device_arrays()

        C, D = plan.cam_cap, plan.draw_cap
        cam_valid = np.zeros((C,), bool)
        viewports = np.zeros((C, 6), np.float32)
        viewports[:, 2:4] = 1.0  # avoid 0/0 aspect for dead cameras
        scissors = np.zeros((C, 4), np.int32)
        view_projs = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        models = np.tile(np.eye(4, dtype=np.float32), (C, D, 1, 1))
        lights = np.zeros((C, 12), np.float32)
        inv_vps = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        eyes = np.zeros((C, 3), np.float32)

        has_light = any(getattr(c, "light", None) is not None for c in cams)
        if has_light != plan.lit:
            self.plan = plan = dataclasses.replace(plan, lit=has_light)

        cam_sigs = []
        for ci, cam in enumerate(cams):
            cam_valid[ci] = True
            vp = cam.viewport
            viewports[ci] = [vp.x, vp.y, vp.width, vp.height,
                             vp.min_depth, vp.max_depth]
            sc = cam.scissor
            scissors[ci] = [sc.x, sc.y, sc.width, sc.height]
            view_projs[ci] = cam.get_projection_matrix() @ cam.view_matrix
            if plan.lit:
                if cam.light is not None:
                    lights[ci] = cam.light.as_array()
                inv_vps[ci] = np.linalg.inv(
                    view_projs[ci].astype(np.float64)).astype(np.float32)
                eyes[ci] = cam.eye_position()
            for di, mesh in enumerate(cam.mesh_renderers):
                models[ci, di] = mesh.model
            cam_sigs.append(tuple(
                (m.indices.offset, m.indices.len, m.vertices.offset,
                 m.texture.slot)
                for m in cam.mesh_renderers
            ))

        corners, tri_draw, tri_valid0, tri_tex = self._triangle_tables(
            render_device, cams, cam_sigs, plan
        )

        # ---- UI assembly (points -> clip on host; ref: ui.vert:16-18) ----
        U = plan.ui_tri_cap
        ui_clip = np.zeros((U, 3, 4), np.float32)
        ui_clip[..., 3] = 1.0
        ui_uv = np.zeros((U, 3, 2), np.float32)
        ui_colors = np.zeros((U, 3, 4), np.float32)
        ui_tex = np.zeros((U,), np.int32)
        ui_valid = np.zeros((U,), bool)
        win_w, win_h = window_size
        if ui_elements and render_resources.ui_indices.len > 0:
            verts = render_resources.ui_vertices.data()    # [N, 8]
            inds = render_resources.ui_indices.data()      # [M]
            screen_pts = (
                float(win_w) / float(scale_factor),
                float(win_h) / float(scale_factor),
            )
            t = 0
            for el in ui_elements:
                tri_idx = inds[el.index_offset : el.index_offset + el.index_len]
                tri_idx = tri_idx.reshape(-1, 3).astype(np.int64) + el.vertex_offset
                n = min(len(tri_idx), U - t)
                if n <= 0:
                    break
                v = verts[tri_idx[:n]]             # [n, 3, 8]
                # UI vertex shader on host (ref: ui.vert:16-18)
                ui_clip[t : t + n, :, 0] = 2.0 * v[..., 0] / screen_pts[0] - 1.0
                ui_clip[t : t + n, :, 1] = 2.0 * v[..., 1] / screen_pts[1] - 1.0
                ui_clip[t : t + n, :, 2] = 0.0
                ui_uv[t : t + n] = v[..., 2:4]
                ui_colors[t : t + n] = v[..., 4:8]
                ui_tex[t : t + n] = el.texture.slot
                ui_valid[t : t + n] = True
                t += n

        window_viewport = np.array(
            [0, 0, float(win_w), float(win_h), 0.0, 1.0], np.float32
        )
        window_scissor = np.array([0, 0, int(win_w), int(win_h)], np.int32)

        # host numpy throughout — record() ships the whole tuple in one
        # batched device_put (texture/triangle-table arrays are already
        # device resident and pass through untouched)
        return (
            texels, toff, tw, th,
            np.asarray(CLEAR_COLOR, np.float32),
            cam_valid, viewports, scissors, view_projs, models,
            corners, tri_draw, tri_valid0, tri_tex,
            lights, inv_vps, eyes,
            ui_clip, ui_uv, ui_colors, ui_tex, ui_valid,
            window_viewport, window_scissor,
        )

    def _triangle_tables(self, render_device, cams, cam_sigs, plan):
        """Cached per-frame triangle tables [C, T, 3, 5] etc.

        Geometry is static between scene edits; the table is rebuilt only
        when a camera's draw list or the geometry arenas change (the key
        includes arena versions). This removes all per-frame gathers from
        the vertex stage — the analog of baked command buffers.
        """
        alloc = render_device.memory_allocator
        varena = alloc.static_vertices_buffer
        iarena = alloc.static_indices_buffer
        key = (
            plan.cam_cap, plan.tri_cap, tuple(cam_sigs),
            varena.version, iarena.version,
        )
        cached = getattr(self, "_tri_table_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        positions, uvs, normals, indices = alloc.geometry_device_arrays()
        C, D, Tcap = plan.cam_cap, plan.draw_cap, plan.tri_cap
        per_cam = []
        for ci in range(C):
            meshes = cams[ci].mesh_renderers if ci < len(cams) else []
            first_index = np.zeros((D,), np.int32)
            vertex_offset = np.zeros((D,), np.int32)
            tri_base = np.full((D,), Tcap, np.int32)
            tri_count = np.zeros((D,), np.int32)
            draw_tex = np.zeros((D,), np.int32)
            base = 0
            for di, mesh in enumerate(meshes):
                first_index[di] = mesh.indices.offset
                vertex_offset[di] = mesh.vertices.offset
                tri_base[di] = base
                tri_count[di] = mesh.triangle_count
                draw_tex[di] = mesh.texture.slot
                base += mesh.triangle_count
            # dead draw slots keep tri_base monotone at `base` so
            # searchsorted maps padding triangles to a zero-count draw
            for di in range(len(meshes), D):
                tri_base[di] = base
            per_cam.append(_build_table(
                positions, uvs, normals, indices,
                *jax.device_put((first_index, vertex_offset, tri_base,
                                 tri_count, draw_tex)),
                tri_capacity=Tcap,
            ))

        tables = tuple(
            jnp.stack([per_cam[ci][k] for ci in range(C)]) for k in range(4)
        )
        tables = jax.block_until_ready(tables)
        self._tri_table_cache = (key, tables)
        return tables
