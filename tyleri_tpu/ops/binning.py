"""Tile binning: expand triangles to (tile, triangle) entries, sort by tile,
and build the sorted entry table the per-tile rasterizer streams.

This is the replacement for the reference's draw-call-level
parallelism (rayon round-robin over secondary command buffers, ref:
src/render_objects/mod.rs:5-30, forward_rendering/mod.rs:297-313): instead of
threads recording draws, the screen is a tile grid and every (tile, triangle)
overlap becomes one work item.  The expand→stable-sort→segment pattern keeps
everything static-shaped for XLA:

  1. each valid triangle whose bbox covers at most ``max_tiles_per_tri``
     tiles contributes one entry per covered tile; bigger ("broad")
     triangles go to a small dense side list that every covered tile scans —
     huge triangles are rare, and each already costs many tiles of work, so
     the side list adds negligible overhead while keeping the expansion
     static-shaped.  Draw-order ties between the two lists are resolved by
     the per-entry CH_ORDER channel in the visibility resolve.
  2. entries are sorted by (tile id, conservative triangle z-min in D16
     quanta — CH_ZMIN) as one packed u32 key when the bit budget allows.
     The visibility resolve is an associative per-pixel lexicographic min
     over (quantized z, CH_ORDER draw order), so any in-tile processing
     order is exact; FRONT-TO-BACK order lets the rasterizer stop a tile's
     stream as soon as every pixel's depth is below the next entry's z-min
     bound (the front-to-back early exit of ops/raster_pallas.py).
     Draw-order depth ties are arbitrated per entry by the CH_ORDER channel
     in both backends.
  3. per-tile segment boundaries come from searchsorted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tyleri_tpu.ops import setup as S
from tyleri_tpu.ops.setup import TriangleSetup


class BinnedEntries(NamedTuple):
    entry_channels: jax.Array  # f32 [E_cap, NUM_CHANNELS] sorted by tile
                               # (row-major is the ONLY layout: a
                               # channel-major twin makes XLA's layout
                               # assignment fuse the transpose INTO the
                               # gather — strided row writes, measured 3.5x
                               # slower than the row gather + the Pallas
                               # kernel's leading-dim chunk DMA)
    entry_tile: jax.Array      # i32 [E_cap] tile id per sorted entry (ntiles = dead)
    tile_start: jax.Array      # i32 [ntiles + 1] segment offsets into entries
    num_entries: jax.Array     # i32 [] total live entries
    overflow: jax.Array        # i32 [] entries dropped (capacity exceeded)
    broad_channels: jax.Array  # f32 [B_cap, NUM_CHANNELS] huge-triangle list
    broad_tiles: jax.Array     # i32 [B_cap, 4] tile bbox (tx0, ty0, tx1, ty1)
    num_broad: jax.Array       # i32 [] live broad entries
    # optional extra per-entry attribute rows (lit path: world-normal/w
    # interpolation planes) gathered with the same permutations
    entry_extra: jax.Array = None     # f32 [E_cap, K]
    broad_extra: jax.Array = None     # f32 [B_cap, K]
    dense_demand: jax.Array = None    # i32 [] live narrow triangles
                                      # (pre-cap dense-slot demand; drives
                                      # the adaptive valid_cap shrink)
    level_demand: jax.Array = None    # i32 [L] per-spill-level triangle
                                      # demand: #(scount >= level's first
                                      # cover index), the prefix length
                                      # level j's cap must hold (pre-cap;
                                      # drives the adaptive
                                      # spill_level_caps fit)


# Per-level capacity fractions of ``spill_cap``, tuned to the measured
# sponza-scale cover histogram at (16, 128) tiles (triangles with
# scount >= 1, 2, 4, 8, 16 are ~13%, 4%, 1.5%, 0.5%, 0.2% of the table;
# fractions carry ~1.2x headroom over those at the default spill_cap).
_LEVEL_FRACS = (0.6, 0.2, 0.08, 0.03, 0.012)


def _level_caps(spill_cap: int, K: int, fracs=_LEVEL_FRACS,
                override=()) -> list[int]:
    """Per-level triangle capacities.  ``override`` (a learned per-level
    demand fit from the frame feedback) replaces the fraction-derived caps:
    the fractions are tuned to ONE cover histogram, and a mismatched scene
    pays for it doubly — truncation triggers the global spill_cap doubling,
    whose emitted row budget the big (tile, zmin) sort then carries as dead
    weight (measured on sponza: the fraction caps under-serve level 0, the
    doubling converges at a 2.8M-row budget for 1.19M live entries)."""
    derived = []
    lo, j = 1, 0
    while lo < K:
        frac = fracs[min(j, len(fracs) - 1)]
        derived.append(max(int(spill_cap * frac) // 512 * 512, 512))
        lo *= 2
        j += 1
    if override:
        assert len(override) == len(derived), \
            f"spill_level_caps needs {len(derived)} levels"
        return [max(int(c) // 512 * 512, 512) for c in override]
    return derived


def spill_rows(spill_cap: int, K: int = 32, level_caps=()) -> int:
    """Total spill slot rows the multi-level expansion emits — callers size
    ``entry_cap`` as tri_cap + spill_rows so the big sort never slices live
    entries (and the result stays a multiple of 128 for the Pallas chunks
    when tri_cap is)."""
    total, lo = 0, 1
    for cap in _level_caps(spill_cap, K, override=level_caps):
        hi = min(2 * lo, K) - 1
        total += (hi - lo + 1) * cap
        lo *= 2
    return total


def bin_triangles(
    setup: TriangleSetup,
    extra=None,   # f32 [T, K] optional per-triangle rows to gather alongside
    *,
    grid_w: int,
    grid_h: int,
    entry_cap: int,
    max_tiles_per_tri: int = 32,
    broad_cap: int = 256,
    spill_cap: int = 1 << 16,
    valid_cap: int = 0,   # dense slots for live narrow triangles (0 = T):
                          # culled/invalid rows beyond it stop riding the
                          # big sort + channel gather as dead weight
    spill_level_caps=(),  # learned per-level cap fit (see _level_caps)
) -> BinnedEntries:
    T = setup.valid.shape[0]
    ntiles = grid_w * grid_h
    K = max_tiles_per_tri

    tx0 = setup.tile_lo[:, 0]
    ty0 = setup.tile_lo[:, 1]
    tx1 = setup.tile_hi[:, 0]
    ty1 = setup.tile_hi[:, 1]
    tw = jnp.maximum(tx1 - tx0 + 1, 0)
    th = jnp.maximum(ty1 - ty0 + 1, 0)
    ncover = jnp.where(setup.valid, tw * th, 0)

    is_broad = setup.valid & (ncover > K)
    is_narrow = setup.valid & (ncover <= K) & (ncover > 0)

    dense_live = jnp.sum(is_narrow.astype(jnp.int32))

    # Expansion from ONE T-row packed 2-operand sort + ELEMENTWISE emits:
    # no data-dependent gather / scatter / jnp.repeat (an HLO scatter-add)
    # per emitted row.  This shape was priced on the previous accelerator,
    # where such rows cost fixed latency each; its cost on the GPU is not
    # measured yet (ROADMAP S4).
    #
    # The sort key packs (dead, 31 - scount, tw - 1, tri) so narrow
    # triangles sort by DESCENDING spill count, giving nested prefixes:
    #   - the first `valid_cap` rows hold every live narrow triangle —
    #     the DENSE (first covered tile) slots, skipping the ~40-50% of
    #     the table that is culled/invalid (those rows would otherwise
    #     ride the big expansion sort and channel gather as dead weight)
    #   - spill level j (slot budget doubling: 1, 2, 4, 8, 16 covers) owns
    #     cover indices [2^(j-1), min(2^j, K) - 1]; the triangles needing
    #     it (scount >= 2^(j-1)) are exactly a PREFIX, sliced at the
    #     static per-level cap — no re-sorts, no gathers
    # Every slot emits its (tile, zmin, tri) purely elementwise from the
    # packed operands; dead slots carry the ntiles sentinel and the big
    # sort moves them past every live entry.  A triangle with scount
    # covers occupies ceil-to-level-boundary slots, a ~1.4x row overhead
    # on sponza-scale histograms — cheap against latency-bound ops.
    tri_ids = jnp.arange(T, dtype=jnp.int32)
    zmin_q = setup.channels[:, S.CH_ZMIN].astype(jnp.int32)  # 0..65535 exact

    scount = jnp.where(is_narrow, jnp.maximum(ncover - 1, 0), 0)
    total_spill = jnp.sum(scount)

    assert grid_w <= 256 and grid_h <= 256, "packed opA needs 8-bit tiles"
    assert K <= 32, "packed key carries scount/tw in 5 bits each"
    assert T < (1 << 21), "packed key carries the triangle id in 21 bits"
    caps = _level_caps(spill_cap, K, override=spill_level_caps)

    # per-level demand: level j holds the descending-scount prefix of
    # triangles with scount >= its first cover index (feedback for the
    # spill_level_caps fit)
    level_demand = jnp.stack([
        jnp.sum((scount >= (1 << j)).astype(jnp.int32))
        for j in range(len(caps))
    ])

    # packed operands (all elementwise; tri ids of equal-scount rows keep
    # every key distinct, so the unstable sort is deterministic):
    #   key = dead<<31 | (31-scount)<<26 | (tw-1)<<21 | tri   (u32, exact)
    #   opA = zmin<<16 | ty0<<8 | tx0                         (u32, exact)
    twc = jnp.clip(tw, 1, K).astype(jnp.uint32)
    key = (
        ((31 - scount).astype(jnp.uint32) << 26)
        | ((twc - 1) << 21)
        | tri_ids.astype(jnp.uint32)
    )
    key = jnp.where(is_narrow, key, jnp.uint32(0xFFFFFFFF))
    opA = (
        (jnp.clip(zmin_q, 0, 65535).astype(jnp.uint32) << 16)
        | (jnp.clip(ty0, 0, 255).astype(jnp.uint32) << 8)
        | jnp.clip(tx0, 0, 255).astype(jnp.uint32)
    )
    vcap = min(valid_cap, entry_cap) if valid_cap else T
    n_pad = max(max(vcap, max(caps)) - T, 0)
    if n_pad:
        key = jnp.concatenate(
            [key, jnp.full((n_pad,), 0xFFFFFFFF, jnp.uint32)])
        opA = jnp.concatenate([opA, jnp.zeros((n_pad,), jnp.uint32)])
    key, opA = jax.lax.sort(
        (key, opA), dimension=0, num_keys=1, is_stable=False)

    def unpack(cap):
        k = key[:cap]
        a = opA[:cap]
        live = k != jnp.uint32(0xFFFFFFFF)
        scnt = (31 - ((k >> 26) & 0x1F).astype(jnp.int32))
        twl = (((k >> 21) & 0x1F) + 1).astype(jnp.int32)
        tril = (k & jnp.uint32((1 << 21) - 1)).astype(jnp.int32)
        zq = (a >> 16).astype(jnp.int32)
        ty = ((a >> 8) & 0xFF).astype(jnp.int32)
        tx = (a & 0xFF).astype(jnp.int32)
        return live, scnt, twl, tril, zq, ty, tx

    # dense slots: every live narrow triangle, compacted
    live, _, _, tril, zq, ty, tx = unpack(vcap)
    seg_tile = [jnp.where(live, ty * grid_w + tx, jnp.int32(ntiles))]
    seg_zmin = [zq]
    seg_tri = [tril]
    placed_dense = jnp.sum(live.astype(jnp.int32))

    placed_spill = jnp.int32(0)
    lo = 1
    for cap in caps:
        hi = min(2 * lo, K) - 1           # cover indices [lo, hi] this level
        live, scnt, twl, tril, zq, ty, tx = unpack(cap)
        for c in range(lo, hi + 1):       # static slot loop, elementwise
            lv = live & (scnt >= c)
            cy = ty + c // twl
            cx = tx + c - (c // twl) * twl
            seg_tile.append(jnp.where(lv, cy * grid_w + cx,
                                      jnp.int32(ntiles)))
            seg_zmin.append(zq)
            seg_tri.append(tril)
            placed_spill = placed_spill + jnp.sum(lv.astype(jnp.int32))
        lo = 2 * lo
        if lo >= K:
            break

    # Live entries actually placed; the overflow terms are disjoint:
    # valid_cap drops, level-cap drops, then entry-cap drops of the rest
    # (possible only when entry_cap < the emitted row budget).
    live_placed = placed_dense + placed_spill
    overflow = (
        (dense_live - placed_dense)
        + (total_spill - placed_spill)
        + jnp.maximum(live_placed - entry_cap, 0)
    )

    rows = sum(s.shape[0] for s in seg_tile)
    pad = max(entry_cap - rows, 0)
    all_tile = jnp.concatenate(seg_tile)
    all_zmin = jnp.concatenate(seg_zmin)
    all_tri = jnp.concatenate(seg_tri)
    if pad:
        all_tile = jnp.concatenate(
            [all_tile, jnp.full((pad,), ntiles, jnp.int32)]
        )
        all_zmin = jnp.concatenate([all_zmin, jnp.zeros((pad,), jnp.int32)])
        all_tri = jnp.concatenate([all_tri, jnp.zeros((pad,), jnp.int32)])

    # Sort by (tile id, conservative z-min): within a tile the rasterizer
    # streams entries FRONT TO BACK, which powers its early exit — once
    # every pixel's depth beats the next entry's z-min bound the rest of the
    # segment cannot contribute (ops/raster_pallas.py).  The per-pixel
    # resolve is an associative lexicographic (z, order) min, so any in-tile
    # order — including the unstable sort's arbitrary order among equal
    # (tile, zmin) keys — produces identical pixels; CH_ORDER arbitrates
    # draw-order ties exactly.  Dead entries carry the ntiles sentinel and
    # sort last, so slicing the first entry_cap sorted rows keeps every live
    # entry (any truncation is counted in ``overflow`` above).
    tile_bits = int(ntiles).bit_length()
    if tile_bits + 16 <= 32:
        key = (
            all_tile.astype(jnp.uint32) << 16
        ) | jnp.clip(all_zmin, 0, 65535).astype(jnp.uint32)
        key, entry_tri = jax.lax.sort(
            (key, all_tri), dimension=0, num_keys=1, is_stable=False
        )
        entry_tile = (key[:entry_cap] >> 16).astype(jnp.int32)
    else:  # huge tile grids: fall back to a two-key sort
        entry_tile, _, entry_tri = jax.lax.sort(
            (all_tile, all_zmin, all_tri),
            dimension=0, num_keys=2, is_stable=False,
        )
        entry_tile = entry_tile[:entry_cap]
    entry_tri = entry_tri[:entry_cap]

    tile_start = jnp.searchsorted(
        entry_tile, jnp.arange(ntiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)

    # Gather the per-entry channel table in sorted order (entry-major rows:
    # one contiguous row gather per entry).  Dead/padding rows are NOT
    # zeroed: every consumer masks by liveness (the Pallas kernel by the
    # [start, end) window, the XLA path by its tile lists), and the masking
    # pass would cost a full extra read+write of the table.
    entry_channels = setup.channels[entry_tri]
    entry_extra = extra[entry_tri] if extra is not None else None

    # Broad (huge) triangles: dense side list, every covered tile scans it.
    # Compacted by inverse lookup (searchsorted over B queries) — a [T]
    # scatter would cost per-source-row latency at millions of triangles.
    num_broad = jnp.sum(is_broad.astype(jnp.int32))
    bcum = jnp.cumsum(is_broad.astype(jnp.int32))
    broad_src = jnp.searchsorted(
        bcum, jnp.arange(1, broad_cap + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    broad_live = (broad_src < T).astype(jnp.int32)
    broad_src = jnp.clip(broad_src, 0, T - 1)
    # dead rows carry garbage channels; consumers mask by the bbox test
    # against the empty-bbox sentinel below
    broad_channels = setup.channels[broad_src]
    bbox = jnp.stack([tx0, ty0, tx1, ty1], axis=1)
    broad_tiles = jnp.where(
        broad_live[:, None] > 0,
        bbox[broad_src],
        jnp.array([[1, 1, 0, 0]], jnp.int32),  # empty bbox for dead slots
    )
    overflow = overflow + jnp.maximum(num_broad - broad_cap, 0)

    return BinnedEntries(
        entry_channels=entry_channels,
        entry_tile=entry_tile,
        tile_start=tile_start,
        num_entries=jnp.minimum(live_placed, entry_cap).astype(jnp.int32),
        overflow=overflow.astype(jnp.int32),
        broad_channels=broad_channels,
        broad_tiles=broad_tiles,
        num_broad=jnp.minimum(num_broad, broad_cap).astype(jnp.int32),
        entry_extra=entry_extra,
        broad_extra=extra[broad_src] if extra is not None else None,
        dense_demand=dense_live.astype(jnp.int32),
        level_demand=level_demand,
    )
