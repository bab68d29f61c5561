"""Visibility-buffer rasterization: per-tile depth resolve over binned entries.

This is the replacement of the per-fragment depth-tested pipeline
(ref pipelines' LESS_OR_EQUAL depth test + write, src/pipeline/
common_pipeline.rs:107-116).  Instead of scattering fragments, every tile
resolves the *visible* entry per pixel (a visibility buffer); texture lookup
and blending happen once per pixel in a deferred shading pass
(ops/shade.py).  Exact Vulkan submission-order semantics for depth ties are
preserved via the CH_ORDER channel: the winner is (min quantized z, then max
draw order) for LESS_OR_EQUAL, (min z, first drawn) for LESS — equivalent to
sequential per-fragment processing in draw order.

Deviation from per-fragment blending: only the final visible fragment is
blended (against the pre-pass framebuffer).  For z-tested opaque content this
matches; overlapping fragments at decreasing depth that each blend would
accumulate differently — use ops/raster_exact for those (and for parity
tests).

This module is the pure-XLA implementation (vmap over tiles); it is the
functional spec for the Pallas kernel in ops/raster_pallas.py and the default
path on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tyleri_tpu.ops import setup as S
from tyleri_tpu.ops.binning import BinnedEntries
from tyleri_tpu.ops.depth import quantize_depth
from tyleri_tpu.pipeline.state import CompareOp, DepthState


class VisibilityBuffer(NamedTuple):
    owner: jax.Array  # i32 [H, W]; index into the combined channel table, -1 = none
    depth: jax.Array  # f32 [H, W]; quantized depth after the pass
    order: jax.Array  # f32 [H, W]; draw order of the owner (-1 = none)
    uw: jax.Array     # f32 [H, W]; winner u/w at the pixel center
    vw: jax.Array     # f32 [H, W]; winner v/w
    iw: jax.Array     # f32 [H, W]; winner 1/w
    tex: jax.Array    # i32 [H, W]; winner texture slot


def attribute_maps(owner, all_channels, fb_w, fb_h, row0=0):
    """Reconstruct winner shading attributes from the channel table (the
    XLA visibility path uses this; the Pallas kernel carries them directly).
    ``row0`` is the frame row of the buffer's first row (a band)."""
    valid = owner >= 0
    safe = jnp.clip(owner, 0, all_channels.shape[0] - 1)
    rows = jnp.array(
        [S.CH_INVW, S.CH_INVW + 1, S.CH_INVW + 2,
         S.CH_UW, S.CH_UW + 1, S.CH_UW + 2,
         S.CH_VW, S.CH_VW + 1, S.CH_VW + 2,
         S.CH_META],
        jnp.int32,
    )
    table = all_channels[:, rows]               # [E, 10] static column slice
    ch = table[safe]                            # [H, W, 10] row gathers
    xc = (jnp.arange(fb_w, dtype=jnp.float32) + 0.5)[None, :]
    yc = ((row0 + jnp.arange(fb_h)).astype(jnp.float32) + 0.5)[:, None]

    def plane(i):
        return ch[..., i] * xc + ch[..., i + 1] * yc + ch[..., i + 2]

    iw = jnp.where(valid, plane(0), 1.0)
    uw = jnp.where(valid, plane(3), 0.0)
    vw = jnp.where(valid, plane(6), 0.0)
    tex = jnp.where(
        valid, ch[..., 9].astype(jnp.int32) & S.META_TEX_MASK, 0
    )
    return uw, vw, iw, tex


def combined_channels(binned: BinnedEntries):
    """Narrow entries followed by broad entries: owner ids index this table."""
    return jnp.concatenate([binned.entry_channels, binned.broad_channels], axis=0)


def build_tile_lists(binned: BinnedEntries, ntiles: int, cap_per_tile: int):
    """Scatter sorted entries into fixed-capacity per-tile lists.

    Returns (tile_lists i32 [ntiles, cap_per_tile] of entry ids, -1 = empty;
    overflow i32 [] = entries beyond any tile's capacity, reported to the
    validation layer — capacity is a ScenePlan knob).
    """
    E = binned.entry_tile.shape[0]
    eid = jnp.arange(E, dtype=jnp.int32)
    tile = binned.entry_tile
    live = tile < ntiles
    rank = eid - binned.tile_start[jnp.clip(tile, 0, ntiles)]
    ok = live & (rank < cap_per_tile)
    slot = jnp.where(ok, tile * cap_per_tile + rank, ntiles * cap_per_tile)
    lists = jnp.full((ntiles * cap_per_tile,), -1, jnp.int32)
    lists = lists.at[slot].set(eid, mode="drop")
    counts = binned.tile_start[1:] - binned.tile_start[:-1]
    overflow = jnp.sum(jnp.maximum(counts - cap_per_tile, 0))
    return lists.reshape(ntiles, cap_per_tile), overflow.astype(jnp.int32)


def _eval_plane(ch, row, xc, yc):
    """Evaluate plane rows [K] over pixels [P]: returns [P, K]."""
    return (ch[:, row][None, :] * xc[:, None]
            + ch[:, row + 1][None, :] * yc[:, None]
            + ch[:, row + 2][None, :])


def _resolve_chunk(ch, live, order, xc, yc, in_scissor, zbuf, owner, obuf, eids,
                   depth_state: DepthState):
    """One chunk of K entries against one tile of P pixels (the inner loop).

    ch: [NUM_CHANNELS, K]; live: bool [K]; order: f32 [K]; xc/yc: f32 [P];
    in_scissor: bool [P]; zbuf/obuf: f32 [P]; owner: i32 [P]; eids: i32 [K].
    """
    e0 = _eval_plane(ch, S.CH_E0, xc, yc)
    e1 = _eval_plane(ch, S.CH_E1, xc, yc)
    # e2 derived from the stored doubled area (e0+e1+e2 == |2A|); the same
    # expression order as the Pallas kernel keeps cross-backend parity exact
    e2 = (ch[:, S.CH_TWOA][None, :] - e0) - e1
    tl = ch[:, S.CH_META].astype(jnp.int32)[None, :] >> S.META_TEX_BITS
    tl0 = (tl & 1) > 0
    tl1 = (tl & 2) > 0
    tl2 = (tl & 4) > 0
    cov = (
        ((e0 > 0) | ((e0 == 0) & tl0))
        & ((e1 > 0) | ((e1 == 0) & tl1))
        & ((e2 > 0) | ((e2 == 0) & tl2))
    )
    z = _eval_plane(ch, S.CH_Z, xc, yc)
    in_bounds = (z >= 0.0) & (z <= 1.0)  # depth clamp off => clip z outside [0,1]
    zq = quantize_depth(z, depth_state.format)
    frag = cov & in_bounds & live[None, :] & in_scissor[:, None]

    if depth_state.test_enable:
        cmp = depth_state.compare_op
        if cmp == CompareOp.LESS_OR_EQUAL:
            passing = frag & (zq <= zbuf[:, None])
        elif cmp == CompareOp.LESS:
            # strict less vs the incumbent depth, EXCEPT when the incumbent
            # was resolved this pass out of draw order (narrow/broad/clip
            # lists): an earlier-drawn fragment may still take an equal-z
            # tie — lexicographic (z, order).  obuf = -1 for pre-pass depth,
            # so equal-z vs prior content correctly fails.
            if depth_state.write_enable:
                passing = frag & (
                    (zq < zbuf[:, None])
                    | ((zq == zbuf[:, None]) & (order[None, :] < obuf[:, None]))
                )
            else:
                passing = frag & (zq < zbuf[:, None])
        elif cmp == CompareOp.ALWAYS:
            passing = frag
        elif cmp == CompareOp.NEVER:
            passing = jnp.zeros_like(frag)
        else:
            raise NotImplementedError(
                f"visibility mode supports LESS/LESS_OR_EQUAL/ALWAYS/NEVER, got {cmp}; "
                "use the exact rasterizer for other compare ops"
            )
    else:
        passing = frag

    if depth_state.write_enable and depth_state.test_enable and depth_state.compare_op in (
        CompareOp.LESS, CompareOp.LESS_OR_EQUAL,
    ):
        # Sequential-equivalent resolve: winner carries min z; ties go to the
        # latest draw order for LESS_OR_EQUAL, the earliest for LESS.
        zmask = jnp.where(passing, zq, jnp.inf)
        m = jnp.min(zmask, axis=1)                      # [P]
        cand = passing & (zq == m[:, None])
        hit = jnp.any(cand, axis=1)
        if depth_state.compare_op == CompareOp.LESS_OR_EQUAL:
            key = jnp.where(cand, order[None, :], -1.0)
            sel = jnp.argmax(key, axis=1)               # max order among cand
            worder = jnp.max(key, axis=1)
            upd = hit & ((m < zbuf) | ((m == zbuf) & (worder >= obuf)))
        else:
            # LESS: the earliest drawn fragment at min z wins (lexicographic
            # (z, order) min — entries may be processed out of draw order
            # across the narrow/broad/clip-tail lists).  obuf = -1 for
            # pre-pass depth, so equal-z vs the incumbent correctly fails.
            key = jnp.where(cand, order[None, :], jnp.inf)
            sel = jnp.argmin(key, axis=1)               # min order among cand
            worder = jnp.where(hit, jnp.min(key, axis=1), -1.0)
            upd = hit & ((m < zbuf) | ((m == zbuf) & (worder < obuf)))
        new_owner = jnp.where(upd, eids[sel], owner)
        new_zbuf = jnp.where(upd, m, zbuf)
        new_obuf = jnp.where(upd, worder, obuf)
        return new_zbuf, new_owner, new_obuf

    # No depth write (or ALWAYS/NEVER/no test): the last drawn passing
    # fragment owns the pixel; zbuf unchanged unless write w/o test.
    key = jnp.where(passing, order[None, :], -1.0)
    worder = jnp.max(key, axis=1)
    sel = jnp.argmax(key, axis=1)
    upd = worder > obuf
    new_owner = jnp.where(upd, eids[sel], owner)
    new_obuf = jnp.where(upd, worder, obuf)
    if depth_state.write_enable:
        zsel = jnp.take_along_axis(zq, sel[:, None], axis=1)[:, 0]
        new_zbuf = jnp.where(upd, zsel, zbuf)
    else:
        new_zbuf = zbuf
    return new_zbuf, new_owner, new_obuf


@functools.partial(
    jax.jit,
    static_argnames=(
        "fb_w", "fb_h", "tile_w", "tile_h", "grid_w", "grid_h",
        "cap_per_tile", "chunk", "depth_state",
    ),
)
def rasterize_visibility(
    binned: BinnedEntries,
    init_depth,   # f32 [fb_h, fb_w] current (quantized) depth buffer
    scissor,      # i32 [4]
    *,
    fb_w: int,
    fb_h: int,
    tile_w: int,
    tile_h: int,
    grid_w: int,
    grid_h: int,
    cap_per_tile: int,
    chunk: int = 32,
    depth_state: DepthState,
    row0=0,       # i32 [] frame row of the buffer's first row (a band)
):
    """Resolve visibility for all tiles. Returns (VisibilityBuffer, overflow)."""
    ntiles = grid_w * grid_h
    cap = -(-cap_per_tile // chunk) * chunk  # round capacity up to chunk
    tile_lists, overflow = build_tile_lists(binned, ntiles, cap)
    all_ch = combined_channels(binned)
    E_cap = binned.entry_channels.shape[0]
    B_cap = binned.broad_channels.shape[0]
    bchunk = min(chunk, B_cap)

    pad_h = grid_h * tile_h
    pad_w = grid_w * tile_w
    depth0 = jnp.pad(
        init_depth,
        ((0, pad_h - fb_h), (0, pad_w - fb_w)),
        constant_values=jnp.float32(-jnp.inf),  # nothing ever passes off-fb
    )
    # [ntiles, P] per-tile flattened initial depth
    depth0_tiles = (
        depth0.reshape(grid_h, tile_h, grid_w, tile_w)
        .transpose(0, 2, 1, 3)
        .reshape(ntiles, tile_h * tile_w)
    )

    scx, scy, scw, sch = (scissor[i] for i in range(4))

    def per_tile(tile_idx, tlist, zinit):
        tx = tile_idx % grid_w
        ty = tile_idx // grid_w
        ys = (row0 + ty * tile_h
              + jnp.arange(tile_h, dtype=jnp.int32))[:, None]
        xs = (tx * tile_w + jnp.arange(tile_w, dtype=jnp.int32))[None, :]
        xi = jnp.broadcast_to(xs, (tile_h, tile_w)).reshape(-1)
        yi = jnp.broadcast_to(ys, (tile_h, tile_w)).reshape(-1)
        xc = xi.astype(jnp.float32) + 0.5
        yc = yi.astype(jnp.float32) + 0.5
        in_scissor = (xi >= scx) & (xi < scx + scw) & (yi >= scy) & (yi < scy + sch)

        P = tile_h * tile_w
        zbuf = zinit
        owner = jnp.full((P,), -1, jnp.int32)
        obuf = jnp.full((P,), -1.0, jnp.float32)

        def narrow_body(carry, eids_chunk):
            zbuf, owner, obuf = carry
            live = eids_chunk >= 0
            safe = jnp.clip(eids_chunk, 0, E_cap - 1)
            ch = all_ch[safe]
            order = ch[:, S.CH_ORDER]
            out = _resolve_chunk(
                ch, live, order, xc, yc, in_scissor, zbuf, owner, obuf,
                safe, depth_state,
            )
            return out, None

        chunks = tlist.reshape(cap // chunk, chunk)
        (zbuf, owner, obuf), _ = jax.lax.scan(
            narrow_body, (zbuf, owner, obuf), chunks
        )

        # Broad (huge-triangle) list: every tile scans it, masked by bbox.
        if B_cap > 0:
            def broad_body(carry, args):
                zbuf, owner, obuf = carry
                bids, bbox = args  # bids [bchunk], bbox [bchunk, 4]
                ch = all_ch[E_cap + bids]
                order = ch[:, S.CH_ORDER]
                live = (
                    (bids < B_cap)
                    & (tx >= bbox[:, 0]) & (tx <= bbox[:, 2])
                    & (ty >= bbox[:, 1]) & (ty <= bbox[:, 3])
                )
                out = _resolve_chunk(
                    ch, live, order, xc, yc, in_scissor, zbuf, owner, obuf,
                    E_cap + bids, depth_state,
                )
                return out, None

            nb = -(-B_cap // bchunk)
            bids_all = jnp.arange(nb * bchunk, dtype=jnp.int32).reshape(nb, bchunk)
            bbox_all = binned.broad_tiles[
                jnp.clip(bids_all, 0, B_cap - 1)
            ]
            (zbuf, owner, obuf), _ = jax.lax.scan(
                broad_body, (zbuf, owner, obuf), (bids_all, bbox_all)
            )

        return zbuf, owner, obuf

    zt, ot, rt = jax.vmap(per_tile)(
        jnp.arange(ntiles, dtype=jnp.int32), tile_lists, depth0_tiles
    )

    def untile(a):
        return (
            a.reshape(grid_h, grid_w, tile_h, tile_w)
            .transpose(0, 2, 1, 3)
            .reshape(pad_h, pad_w)[:fb_h, :fb_w]
        )

    owner = untile(ot)
    uw, vw, iw, tex = attribute_maps(owner, all_ch, fb_w, fb_h, row0)
    vis = VisibilityBuffer(owner=owner, depth=untile(zt), order=untile(rt),
                           uw=uw, vw=vw, iw=iw, tex=tex)
    return vis, overflow
