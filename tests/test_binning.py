"""Binning invariants: dense-first-tile + spill expansion vs a brute-force
reference, front-to-back (z-min) streaming within tiles, and spill-overflow
reporting (overflow is reported, never silently dropped — the plan
invariant)."""

import jax.numpy as jnp
import numpy as np

from tyleri_tpu.ops.binning import bin_triangles
from tyleri_tpu.ops.setup import setup_triangles


def make_setup(rng, T=800, grid_w=9, grid_h=7, tile=16):
    w = grid_w * tile
    h = grid_h * tile
    base = rng.uniform(-0.9, 0.9, (T, 1, 2))
    ext = rng.uniform(0.01, 0.2, (T, 3, 2)) * rng.choice([-1, 1], (T, 3, 2))
    xy = np.clip(base + ext, -1, 1).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (T, 1)).astype(np.float32)
    clip = np.concatenate(
        [xy, np.broadcast_to(z[:, :, None], (T, 3, 1)),
         np.ones((T, 3, 1), np.float32)], axis=2)
    uv = rng.uniform(0, 1, (T, 3, 2)).astype(np.float32)
    valid = rng.random(T) > 0.2
    su = setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((T,), jnp.int32), jnp.asarray(valid),
        jnp.asarray([0.0, 0.0, w, h, 0.0, 1.0], jnp.float32),
        jnp.asarray([0, 0, w, h], jnp.int32),
        tile_w=tile, tile_h=tile, grid_w=grid_w, grid_h=grid_h,
        order=jnp.arange(T, dtype=jnp.float32),
    )
    return su, grid_w, grid_h


def brute_force_tiles(su, grid_w, grid_h, K):
    """Reference (tile, order) multiset per tile, narrow triangles only."""
    lo = np.asarray(su.tile_lo)
    hi = np.asarray(su.tile_hi)
    valid = np.asarray(su.valid)
    per_tile = {}
    for t in range(len(valid)):
        if not valid[t]:
            continue
        ncover = (hi[t, 0] - lo[t, 0] + 1) * (hi[t, 1] - lo[t, 1] + 1)
        if ncover <= 0 or ncover > K:
            continue
        for ty in range(lo[t, 1], hi[t, 1] + 1):
            for tx in range(lo[t, 0], hi[t, 0] + 1):
                per_tile.setdefault(ty * grid_w + tx, []).append(t)
    return per_tile


def test_binning_matches_brute_force_and_streams_front_to_back():
    su, grid_w, grid_h = make_setup(np.random.default_rng(3))
    K = 32
    b = bin_triangles(su, grid_w=grid_w, grid_h=grid_h, entry_cap=1 << 14,
                      max_tiles_per_tri=K, broad_cap=16, spill_cap=1 << 13)
    assert int(b.overflow) == 0
    ref = brute_force_tiles(su, grid_w, grid_h, K)
    tile_start = np.asarray(b.tile_start)
    # reconstruct per-tile triangle lists from the sorted table
    # (order == slot for this scene, read from the CH_ORDER channel)
    from tyleri_tpu.ops import setup as S

    orders = np.asarray(b.entry_channels)[:, S.CH_ORDER].astype(int)
    zmins = np.asarray(b.entry_channels)[:, S.CH_ZMIN]
    for tile_id, tris in ref.items():
        s, e = tile_start[tile_id], tile_start[tile_id + 1]
        got = sorted(orders[s:e].tolist())
        assert got == sorted(tris), f"tile {tile_id}"
        # front-to-back streaming: the segment ascends in the z-min bound
        # (the early-exit invariant of the Pallas kernel)
        assert (np.diff(zmins[s:e]) >= 0).all()
    total_ref = sum(len(v) for v in ref.values())
    assert int(b.num_entries) == total_ref


def test_spill_overflow_is_reported_not_dropped_silently():
    su, grid_w, grid_h = make_setup(np.random.default_rng(4))
    generous = bin_triangles(su, grid_w=grid_w, grid_h=grid_h,
                             entry_cap=1 << 14, max_tiles_per_tri=32,
                             broad_cap=16, spill_cap=1 << 13)
    assert int(generous.overflow) == 0
    tight = bin_triangles(su, grid_w=grid_w, grid_h=grid_h,
                          entry_cap=1 << 14, max_tiles_per_tri=32,
                          broad_cap=16, spill_cap=128)
    # the scene has far more than 128 spill entries: must be REPORTED
    assert int(tight.overflow) > 0


def test_valid_cap_compaction_is_exact_and_truncation_reported():
    """A valid_cap >= the live narrow count produces identical per-tile
    lists to the full table (the dense compaction is lossless); one below
    it REPORTS the dropped dense slots."""
    su, grid_w, grid_h = make_setup(np.random.default_rng(5))
    kwargs = dict(grid_w=grid_w, grid_h=grid_h, entry_cap=1 << 14,
                  max_tiles_per_tri=32, broad_cap=16, spill_cap=1 << 13)
    full = bin_triangles(su, **kwargs)
    demand = int(full.dense_demand)
    assert 0 < demand < su.valid.shape[0]  # scene has culled/invalid rows

    shrunk = bin_triangles(su, valid_cap=demand, **kwargs)
    assert int(shrunk.overflow) == 0
    assert int(shrunk.num_entries) == int(full.num_entries)
    from tyleri_tpu.ops import setup as S

    ts_f = np.asarray(full.tile_start)
    ts_s = np.asarray(shrunk.tile_start)
    of = np.asarray(full.entry_channels)[:, S.CH_ORDER].astype(int)
    os_ = np.asarray(shrunk.entry_channels)[:, S.CH_ORDER].astype(int)
    for tile_id in range(grid_w * grid_h):
        a = sorted(of[ts_f[tile_id]:ts_f[tile_id + 1]].tolist())
        b = sorted(os_[ts_s[tile_id]:ts_s[tile_id + 1]].tolist())
        assert a == b, f"tile {tile_id}"

    tight = bin_triangles(su, valid_cap=max(demand - 64, 1), **kwargs)
    assert int(tight.overflow) >= 64


def test_adaptive_valid_cap_feedback():
    """note_overflow learns the dense-slot demand, shrinks valid_cap (and
    the derived entry_cap) once stable, and resets on a bin overflow."""
    import tyleri_tpu as ty
    from tyleri_tpu.ops.binning import spill_rows
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
    # a >2-granule triangle table so a shrink can save >= 1 granule
    rf._grow_plan(1, 1, (1 << 17) + 5, 0)
    p0 = rf.plan
    assert p0.tri_cap >= (1 << 17)

    for _ in range(rf._valid_shrink_after):
        rf.note_overflow(0, 0, 0, 0, bin_demand=50_000)
    p1 = rf.plan
    assert p1.raster.valid_cap == 1 << 16  # ceil(62500 / 65536) granules
    rf._grow_plan(1, 1, (1 << 17) + 5, 0)  # steady-state record re-derives
    p1 = rf.plan
    # the dense base IS valid_cap (demand already counts post-clip rows)
    assert p1.raster.entry_cap == (1 << 16) \
        + spill_rows(p1.raster.spill_cap, p1.raster.max_tiles_per_tri)

    # overflow resets to the full table and backs off the threshold
    before = rf._valid_shrink_after
    rf.note_overflow(123, 0, 0, 0, bin_demand=0)
    assert rf.plan.raster.valid_cap == 0
    assert rf._valid_shrink_after == before * 2

    # a tri_cap growth also invalidates a learned shrink
    for _ in range(rf._valid_shrink_after):
        rf.note_overflow(0, 0, 0, 0, bin_demand=50_000)
    assert rf.plan.raster.valid_cap
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    assert rf.plan.raster.valid_cap == 0


def test_adaptive_entry_slice_feedback():
    """note_overflow learns the live entry demand and slices entry_cap
    below the emitted row budget (the (tile, zmin) sort keeps dead rows
    last, so the slice only drops dead weight); a bin overflow resets the
    fit and backs off, and a tri_cap growth invalidates it."""
    import tyleri_tpu as ty
    from tyleri_tpu.ops.binning import spill_rows
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    p0 = rf.plan
    budget = p0.tri_cap + p0.raster.clip_cap + spill_rows(
        p0.raster.spill_cap, p0.raster.max_tiles_per_tri)
    assert p0.raster.entry_cap == budget

    # demand well below the budget: the fit engages after N clean frames
    for _ in range(rf._entry_shrink_after):
        rf.note_overflow(0, 0, 0, 0, entry_demand=100_000)
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    p1 = rf.plan
    assert p1.raster.entry_cap == (1 << 17)  # ceil(125000/65536) granules
    assert p1.raster.entry_cap % p1.raster.chunk == 0

    # overflow (possibly the slice truncating live entries): reset + backoff
    before = rf._entry_shrink_after
    rf.note_overflow(7, 0, 0, 0)
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    assert rf.plan.raster.entry_cap >= budget - (1 << 16)  # valid_cap may
    assert rf._entry_shrink_after == before * 2            # also have reset

    # re-learn, then a geometry growth invalidates the learned fit
    for _ in range(rf._entry_shrink_after):
        rf.note_overflow(0, 0, 0, 0, entry_demand=100_000)
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    assert rf.plan.raster.entry_cap == (1 << 17)
    rf._grow_plan(1, 1, (1 << 19) + 5, 0)
    assert rf._entry_fit == 0
    assert rf.plan.raster.entry_cap > (1 << 19)


def test_adaptive_spill_level_fit():
    """Clean frames teach note_overflow the per-spill-level demand; the
    plan's spill_level_caps replace the fraction-derived caps and shrink
    the emitted row budget; overflow resets to the fraction budget."""
    import tyleri_tpu as ty
    from tyleri_tpu.ops.binning import spill_rows
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    p0 = rf.plan
    demand = [9000, 4000, 900, 300, 100]
    for _ in range(rf._entry_shrink_after):
        rf.note_overflow(0, 0, 0, 0, entry_demand=100_000,
                         spill_demand=demand)
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    p1 = rf.plan
    exp = tuple(max(-(-int(d * 1.25) // 512) * 512, 512) for d in demand)
    assert p1.raster.spill_level_caps == exp
    fitted = spill_rows(p1.raster.spill_cap,
                        p1.raster.max_tiles_per_tri, exp)
    assert fitted < spill_rows(p0.raster.spill_cap,
                               p0.raster.max_tiles_per_tri)
    assert p1.raster.entry_cap % p1.raster.chunk == 0

    # overflow: back to the fraction-derived budget (spill_cap just grew)
    rf.note_overflow(5, 0, 0, 0)
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    assert rf.plan.raster.spill_level_caps == ()


def test_spill_level_caps_binning_matches_fraction_caps():
    """Binning with fitted level caps (>= demand) produces the same
    per-tile streams as the fraction-derived caps; an under-demand level
    cap REPORTS the truncation."""
    from tyleri_tpu.ops import setup as S
    from tyleri_tpu.ops.binning import _level_caps, bin_triangles

    su, grid_w, grid_h = make_setup(np.random.default_rng(12))
    kwargs = dict(grid_w=grid_w, grid_h=grid_h, entry_cap=1 << 14,
                  max_tiles_per_tri=32, broad_cap=16, spill_cap=1 << 13)
    full = bin_triangles(su, **kwargs)
    assert int(full.overflow) == 0
    dem = np.asarray(full.level_demand)
    assert dem[0] > 0
    fit = tuple(max(-(-int(d * 1.25) // 512) * 512, 512) for d in dem)
    fitted = bin_triangles(su, spill_level_caps=fit, **kwargs)
    assert int(fitted.overflow) == 0
    assert int(fitted.num_entries) == int(full.num_entries)
    ts_f = np.asarray(full.tile_start)
    ts_s = np.asarray(fitted.tile_start)
    of = np.asarray(full.entry_channels)[:, S.CH_ORDER].astype(int)
    os_ = np.asarray(fitted.entry_channels)[:, S.CH_ORDER].astype(int)
    for tile_id in range(grid_w * grid_h):
        a = sorted(of[ts_f[tile_id]:ts_f[tile_id + 1]].tolist())
        b = sorted(os_[ts_s[tile_id]:ts_s[tile_id + 1]].tolist())
        assert a == b, f"tile {tile_id}"
    # under-demand level cap: truncation must be REPORTED
    n_levels = len(_level_caps(1 << 13, 32))
    assert len(fit) == n_levels
    tight = (512,) * n_levels
    if dem[0] > 512:
        t = bin_triangles(su, spill_level_caps=tight, **kwargs)
        assert int(t.overflow) > 0


def test_entry_slice_matches_full_capacity_pixels():
    """A sliced entry_cap (above live demand) produces identical binned
    streams per tile — the dropped rows are dead padding only."""
    from tyleri_tpu.ops import setup as S

    su, grid_w, grid_h = make_setup(np.random.default_rng(11))
    kwargs = dict(grid_w=grid_w, grid_h=grid_h, max_tiles_per_tri=32,
                  broad_cap=16, spill_cap=1 << 13)
    full = bin_triangles(su, entry_cap=1 << 14, **kwargs)
    live = int(full.num_entries)
    assert 0 < live < (1 << 12)
    sliced = bin_triangles(su, entry_cap=1 << 12, **kwargs)
    assert int(sliced.overflow) == 0
    assert int(sliced.num_entries) == live
    ts_f = np.asarray(full.tile_start)
    ts_s = np.asarray(sliced.tile_start)
    of = np.asarray(full.entry_channels)[:, S.CH_ORDER].astype(int)
    os_ = np.asarray(sliced.entry_channels)[:, S.CH_ORDER].astype(int)
    for tile_id in range(grid_w * grid_h):
        a = sorted(of[ts_f[tile_id]:ts_f[tile_id + 1]].tolist())
        b = sorted(os_[ts_s[tile_id]:ts_s[tile_id + 1]].tolist())
        assert a == b, f"tile {tile_id}"
    # a slice BELOW the live demand reports the truncation
    tight = bin_triangles(su, entry_cap=max(live - 100, 128) // 128 * 128,
                          **kwargs)
    assert int(tight.overflow) > 0


def test_broad_list_grows_past_old_ceiling_and_kernel_resolves_it():
    """The broad side list stays in device memory, so repeated bin
    overflows quadruple broad_cap with no ceiling, and the visibility
    kernel resolves a broad table longer than 4096 rows (the bound an
    on-chip copy of the list used to impose) exactly like the XLA path."""
    import tyleri_tpu as ty
    from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
    from tyleri_tpu.ops.visibility import rasterize_visibility
    from tyleri_tpu.pipeline.state import CompareOp, DepthState
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
    b0 = rf.plan.raster.broad_cap
    for _ in range(5):
        rf.note_overflow(123, 0, 0, 0, bin_demand=0)
    assert rf.plan.raster.broad_cap == b0 * 4 ** 5 > 4096

    rng = np.random.default_rng(0)
    T = 48
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., :2] = rng.uniform(-1.2, 1.2, (T, 3, 2))   # mostly broad
    clip[..., 2] = rng.uniform(0.1, 0.9, (T, 1))
    clip[..., 3] = 1.0
    su = setup_triangles(
        jnp.asarray(clip), jnp.zeros((T, 3, 2), jnp.float32),
        jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
        jnp.asarray([0.0, 0.0, 32.0, 32.0, 0.0, 1.0], jnp.float32),
        jnp.asarray([0, 0, 32, 32], jnp.int32),
        tile_w=16, tile_h=16, grid_w=2, grid_h=2,
        order=jnp.arange(T, dtype=jnp.float32))
    binned = bin_triangles(su, grid_w=2, grid_h=2, entry_cap=256,
                           max_tiles_per_tri=2, broad_cap=4097,
                           spill_cap=128)
    assert int(binned.num_broad) > 0 and int(binned.overflow) == 0
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    geom = dict(fb_w=32, fb_h=32, tile_w=16, tile_h=16, grid_w=2, grid_h=2,
                chunk=32, depth_state=ds)
    depth = jnp.ones((32, 32), jnp.float32)
    scissor = jnp.asarray([0, 0, 32, 32], jnp.int32)
    vk, _ = rasterize_visibility_pallas(binned, depth, scissor,
                                        interpret=True, **geom)
    vx, _ = rasterize_visibility(binned, depth, scissor, cap_per_tile=256,
                                 **geom)
    assert (np.asarray(vx.owner) >= 256).any()   # broad winners exist
    np.testing.assert_array_equal(np.asarray(vk.owner), np.asarray(vx.owner))
    np.testing.assert_array_equal(np.asarray(vk.depth), np.asarray(vx.depth))


def test_entry_fit_stage2_tighten():
    """After a long clean streak the 1.25x fits re-fit at 1.10x (stage-2
    tighten, BASELINE.md round-5: worth ~2 ms/frame on sponza); overflow
    resets BOTH stages and doubles the streak requirement."""
    import tyleri_tpu as ty
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    demand = [9000, 4000, 900, 300, 100]
    n_stage1 = rf._entry_shrink_after
    n_stage2 = rf._entry_tighten_mult * n_stage1
    assert n_stage2 > n_stage1
    for _ in range(n_stage1):
        rf.note_overflow(0, 0, 0, 0, entry_demand=55_000,
                         spill_demand=demand)
    fit1 = rf._entry_fit
    assert fit1 == -(-int(55_000 * 1.25) // (1 << 16)) * (1 << 16)
    assert rf._fit_stage == 1
    spill1 = rf._spill_fit

    # more clean frames up to the tighten threshold: stage 2 engages once
    for _ in range(n_stage2 - n_stage1):
        rf.note_overflow(0, 0, 0, 0, entry_demand=55_000,
                         spill_demand=demand)
    assert rf._fit_stage == 2
    fit2 = rf._entry_fit
    assert fit2 == -(-int(55_000 * 1.10) // (1 << 16)) * (1 << 16)
    assert fit2 < fit1
    exp2 = tuple(max(-(-int(d * 1.10) // 512) * 512, 512) for d in demand)
    assert rf._spill_fit == exp2
    assert any(a <= b for a, b in zip(exp2, spill1))
    rf._grow_plan(1, 1, (1 << 18) + 5, 0)
    assert rf.plan.raster.entry_cap == fit2
    assert rf.plan.raster.spill_level_caps == exp2
    assert rf.plan.raster.entry_cap % rf.plan.raster.chunk == 0

    # overflow: both stages reset, streak requirement doubles
    before = rf._entry_shrink_after
    rf.note_overflow(3, 0, 0, 0)
    assert rf._entry_fit == 0 and rf._fit_stage == 0
    assert rf._entry_shrink_after == before * 2

    # TYLERI_TIGHTEN=0 disables stage 2 (stage 1 still fits)
    import os
    os.environ["TYLERI_TIGHTEN"] = "0"
    try:
        rf2 = ty.ForwardRenderingFunction(dev, ImageViewSwapchain((64, 64)))
        rf2._grow_plan(1, 1, (1 << 18) + 5, 0)
        for _ in range(64):
            rf2.note_overflow(0, 0, 0, 0, entry_demand=55_000)
        assert rf2._entry_fit == fit1
        assert rf2._fit_stage == 1
    finally:
        del os.environ["TYLERI_TIGHTEN"]
