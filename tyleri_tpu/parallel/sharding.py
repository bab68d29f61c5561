"""Multi-chip frame rendering via shard_map over a (draws, tiles) mesh.

Sort-first + sort-last hybrid (see parallel/mesh.py): every device renders
the draw subset of its ``draws`` coordinate into the framebuffer band of its
``tiles`` coordinate, then bands are composited across the ``draws`` axis by
depth — pmin/pmax/psum reductions over the interconnect whose per-device traffic is
independent of the ``draws`` axis size (the depth resolve is associative, so
it needs no gather).  Geometry/scene inputs are replicated; the output
framebuffer is sharded over its row axis.

Semantics note: the cross-device composite resolves depth ties
lexicographically on (depth, global draw order) using the Frame.order map,
so round-robined draws (ref ParallelGroup semantics
src/render_objects/mod.rs:5-30) resolve exactly as single-chip submission
order would.  Exception: plan.exact mode has no order map (order stays -1
for meshes) and equal-depth ties then fall back to the lowest device index.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tyleri_tpu.parallel.mesh import AXIS_DRAWS, AXIS_TILES
from tyleri_tpu.rendering.forward import FramePlan, frame_body


def _band_plan(plan: FramePlan, n_tile_shards: int) -> FramePlan:
    """Per-shard band plan: ``band_h = ceil(fb_h / n_tile_shards)``.

    Non-divisible heights are PADDED, not rejected: every shard renders a
    full ``band_h`` band and the composite's caller crops the padded rows
    (``band_h * n - fb_h`` < n rows, rendered clear because the window
    scissor — global-height-sized — clips them).  The raster kernels
    already handle arbitrary band heights (they pad to the tile grid
    internally and crop)."""
    band_h = -(-plan.raster.fb_h // n_tile_shards)
    return dataclasses.replace(
        plan, raster=dataclasses.replace(plan.raster, fb_h=band_h)
    )


def derive_draw_groups(cameras, n_draw_shards: int):
    """Production draw partitioning for the ``draws`` mesh axis: each
    camera's draw list round-robins through ParallelGroup exactly as the
    reference spreads draws over rayon threads
    (Camera::get_and_order_meshes -> ParallelGroup, ref:
    src/render_objects/camera.rs:32-39, mod.rs:5-30).  Returns, per camera,
    one list of draw indices per shard.  The compiled shard function's
    ``draw_id % n`` mask is the vectorized form of this grouping — asserted
    here so the two can never drift."""
    out = []
    for cam in cameras:
        pg = cam.get_and_order_meshes(n_draw_shards)
        per_dev = []
        for g in range(n_draw_shards):
            items = pg.get_group_by_thread(g) or []
            expect = cam.mesh_renderers[g::n_draw_shards]
            # a real exception (not assert): the check must survive
            # python -O, or a ParallelGroup change would silently desync
            # the sharded output from the reference partitioning
            if [id(m) for m in items] != [id(m) for m in expect]:
                raise RuntimeError(
                    "ParallelGroup round-robin drifted from the draw%n "
                    "sharding mask"
                )
            per_dev.append(list(range(g, len(cam.mesh_renderers), n_draw_shards)))
        out.append(per_dev)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("plan", "mesh_state", "ui_state", "mesh"),
)
def render_frame_sharded(plan, mesh_state, ui_state, mesh, *arrays):
    """Sharded frame program. ``arrays`` is the same tuple `_render_frame`
    takes (geometry, textures, scene SoA, UI, window rects); returns
    (color [H, W, 4] sharded over rows, depth [H, W], order [H, W],
    bin_overflow [], tile_overflow [], clip_overflow [] — overflows summed
    over the mesh)."""
    nd = mesh.shape[AXIS_DRAWS]
    nt = mesh.shape[AXIS_TILES]
    bplan = _band_plan(plan, nt)
    band_h = bplan.raster.fb_h
    C, D = plan.cam_cap, plan.draw_cap

    def shard_fn(*arrs):
        di = jax.lax.axis_index(AXIS_DRAWS)
        ti = jax.lax.axis_index(AXIS_TILES)
        y0 = (ti * band_h).astype(jnp.int32)
        # round-robin draw assignment to the draws axis (ParallelGroup)
        frame = frame_body(
            bplan, mesh_state, ui_state, *arrs,
            band_y0=y0, draw_mod=(jnp.int32(nd), di.astype(jnp.int32)),
        )
        # composite across the draws axis: lexicographic (depth, order) —
        # min depth wins; equal-depth ties follow the pipeline's compare
        # op on the GLOBAL draw order (Frame.order): LESS_OR_EQUAL lets a
        # later equal-z draw overwrite (max order wins), strict LESS keeps
        # the earliest (min order wins, matching the single-chip
        # first-draw-wins arbitration) — reproducing submission-order
        # semantics (ref: src/pipeline/common_pipeline.rs:107-116)
        # independent of which device a draw round-robined to
        from tyleri_tpu.pipeline.state import CompareOp

        # The reduction is associative, so express it as XLA reductions
        # (pmin/pmax/psum ride efficient ring/tree schedules whose per-device
        # traffic is ~2x the band size REGARDLESS of nd) instead of
        # all_gathering 3 band buffers to every device (traffic and memory
        # x nd).  depth >= 0, so its f32 bit pattern is order-preserving as
        # i32 and pmin over the bits is the exact f32 depth min.
        zbits = jax.lax.bitcast_convert_type(frame.depth, jnp.int32)
        zbits_min = jax.lax.pmin(zbits, AXIS_DRAWS)            # [bh, W]
        at_min = zbits == zbits_min
        if mesh_state.depth.compare_op == CompareOp.LESS:
            okey = jnp.where(at_min, frame.order, jnp.inf)
            owin = jax.lax.pmin(okey, AXIS_DRAWS)
        else:
            okey = jnp.where(at_min, frame.order, -jnp.inf)
            owin = jax.lax.pmax(okey, AXIS_DRAWS)
        win = at_min & (okey == owin)
        # duplicated (depth, order) keys — e.g. the clear background, which
        # every device shares — break to the lowest device index, matching
        # the all_gather composite's argmin/argmax
        owner = jax.lax.pmin(
            jnp.where(win, di.astype(jnp.int32), jnp.int32(nd)), AXIS_DRAWS
        )
        mine = win & (di.astype(jnp.int32) == owner)
        color = jax.lax.psum(
            jnp.where(mine[..., None], frame.color, 0.0), AXIS_DRAWS
        )
        depth = jax.lax.bitcast_convert_type(zbits_min, jnp.float32)
        order = owin
        bin_of = jax.lax.psum(frame.bin_overflow, (AXIS_DRAWS, AXIS_TILES))
        tile_of = jax.lax.psum(frame.tile_overflow, (AXIS_DRAWS, AXIS_TILES))
        clip_of = jax.lax.psum(frame.clip_overflow, (AXIS_DRAWS, AXIS_TILES))
        clip_x = jax.lax.psum(frame.clip_crossings, (AXIS_DRAWS, AXIS_TILES))
        return color, depth, order, bin_of, tile_of, clip_of, clip_x

    in_specs = tuple(P() for _ in arrays)
    shard = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(AXIS_TILES, None, None), P(AXIS_TILES, None),
                   P(AXIS_TILES, None), P(), P(), P(), P()),
        check_vma=False,  # outputs are replicated over AXIS_DRAWS by the
                          # pmin/psum composite; skip the static proof
    )
    color, depth, order, *stats = shard(*arrays)
    fb_h = plan.raster.fb_h
    if nt * band_h != fb_h:
        # non-divisible height: bands were padded to ceil(fb_h/nt); drop
        # the clear-rendered padding rows (only the last band is partial)
        color, depth, order = color[:fb_h], depth[:fb_h], order[:fb_h]
    return (color, depth, order, *stats)
