"""Pallas kernel (Triton route) for the per-tile visibility resolve — the
hot loop of every mesh frame.

Functionally identical to ops/visibility.py (the plain XLA reference; tests
assert agreement), but it pays for live entries instead of static slots:

* one program per screen tile.  Tiles are independent, so nothing carries
  between programs; the tile's pixels are one [tile_h, tile_w] block spread
  over the program's warps
* each program reads its own segment bounds ``tile_start[t]`` and
  ``tile_start[t + 1]`` and walks the binned entries of that segment in
  row-major [E, NUM_CHANNELS] order, one entry at a time: the entry's plane
  coefficients are scalar loads broadcast over the tile's pixels
* the per-pixel resolve is an associative lexicographic min over
  (quantized z, CH_ORDER draw order) — exactly Vulkan submission-order
  semantics for LESS / LESS_OR_EQUAL depth test+write, in any processing
  order.  Binning sorts each tile's entries FRONT TO BACK by a conservative
  per-triangle z-min bound (CH_ZMIN), and the walk carries the threshold
  ``max(zbuf)`` of the tile: once a chunk's first entry has a z-min above
  it, no remaining entry in the ascending stream can pass the depth test
  anywhere in the tile, so the segment's walk stops — *exactly*, not
  approximately (the bound construction in ops/setup.py::_zmin_quantized
  covers f32 evaluation error)
* the huge-triangle ("broad") side list stays in device memory and is
  scanned by every tile with a bbox test after the narrow stream (order of
  lists is immaterial: same associative resolve), bounded by its live count

Depth semantics: LESS_OR_EQUAL / LESS with depth test+write (the reference
pipelines' configuration, ref: src/pipeline/common_pipeline.rs:107-116).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tyleri_tpu.ops import setup as S
from tyleri_tpu.ops.binning import BinnedEntries
from tyleri_tpu.ops.visibility import VisibilityBuffer
from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState

# entries resolved per inner-loop iteration: their scalar loads are
# independent of each other, so the compiler can issue them together
_UNROLL = 4
_INV_Q = 1.0 / 65535.0


def _round_half_even(x):
    """Round-to-nearest-even for 0 <= x < 2^22 (the D16 grid scale), with
    floor alone — the Triton route has no round primitive.  ``x + 0.5`` is
    exact in that range, so this equals jnp.round bit for bit."""
    r = jnp.floor(x + 0.5)
    tie = (r - x) == 0.5
    odd = (r - 2.0 * jnp.floor(r * 0.5)) == 1.0
    return jnp.where(tie & odd, r - 1.0, r)


def kernel_supports(tile_w: int, tile_h: int, depth_state: DepthState) -> bool:
    """The kernel's envelope: power-of-two tile sides (Triton blocks) and
    depth test+write with LESS / LESS_OR_EQUAL."""
    def pow2(n):
        return n > 0 and n & (n - 1) == 0

    return (
        pow2(tile_w) and pow2(tile_h)
        and depth_state.test_enable and depth_state.write_enable
        and depth_state.compare_op in (CompareOp.LESS, CompareOp.LESS_OR_EQUAL)
    )


def _visibility_kernel(
    tile_start_ref,   # i32 [ntiles + 1] segment offsets
    scissor_ref,      # i32 [5] scissor (x, y, w, h) in frame coordinates,
                      # then the frame row of the tile grid's first row
    nbroad_ref,       # i32 [1] live broad-entry count
    entries_ref,      # f32 [E, NUM_CHANNELS] row-major sorted entry table
    broad_ch_ref,     # f32 [B, NUM_CHANNELS]
    broad_tiles_ref,  # i32 [B, 4] tile bbox (tx0, ty0, tx1, ty1)
    depth_init_ref,   # f32 [tile_h, tile_w] block
    *out_refs,        # 7 [tile_h, tile_w] blocks (owner, z, order, uw, vw,
                      # iw, tex), 7 more for layer 2 if peel2
    tile_w: int,
    tile_h: int,
    grid_w: int,
    chunk: int,
    e_cap: int,
    n_broad_cap: int,
    owner_base: int,   # LOGICAL entry-table length: broad owner j maps to
                       # owner_base + j (shade and the lit path index
                       # concat(entry, broad) tables)
    d16: bool,
    le: bool,
    peel2: bool,
):
    gy = pl.program_id(0)
    gx = pl.program_id(1)
    t = gy * grid_w + gx
    start = tile_start_ref[t]
    end = tile_start_ref[t + 1]

    shape = (tile_h, tile_w)
    row0 = scissor_ref[4]
    xc = gx * tile_w + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    yc = row0 + gy * tile_h + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    xf = xc.astype(jnp.float32) + 0.5
    yf = yc.astype(jnp.float32) + 0.5
    sx, sy, sw, sh = (scissor_ref[i] for i in range(4))
    in_scissor = (xc >= sx) & (xc < sx + sw) & (yc >= sy) & (yc < sy + sh)

    def resolve(coeff, eid, live, st):
        """One entry vs the tile.  ``coeff(row)`` is a scalar load of the
        entry's plane coefficient; liveness folds into the coverage mask.

        Equal-depth ties resolve lexicographically by the CH_ORDER channel
        against the incumbent's order — LE keeps the latest draw, LESS the
        earliest (obuf = -1 for pre-pass depth, so equal-z vs prior content
        correctly fails under LESS and passes under LE).

        peel2: the state additionally holds the depth-record holder
        immediately BEFORE the winner drew — the second-to-last surviving
        fragment of the exact sequential depth test (see the rules at the
        update site below; the naive global top-2 by (z, order) can select
        a fragment exact mode never blended).  The deferred shade applies
        the blend equation over layer2-then-layer1, recovering per-fragment
        sequential blending exactly on every pixel with <= 2 surviving
        fragments and truncating deeper survivors (ref
        src/pipeline/common_pipeline.rs:117-131)."""
        if peel2:
            (zbuf, owner, obuf, uwb, vwb, iwb, texb,
             z2, own2, o2, uw2, vw2, iw2, tex2) = st
        else:
            zbuf, owner, obuf, uwb, vwb, iwb, texb = st

        def plane(row):
            return coeff(row) * xf + coeff(row + 1) * yf + coeff(row + 2)

        meta = coeff(S.CH_META).astype(jnp.int32)
        tl = meta >> S.META_TEX_BITS
        e0 = plane(S.CH_E0)
        e1 = plane(S.CH_E1)
        # derived edge: e0+e1+e2 == |2A|; expression order matches
        # ops/visibility.py exactly for cross-backend parity
        e2 = (coeff(S.CH_TWOA) - e0) - e1
        cov = (
            ((e0 > 0) | ((e0 == 0) & ((tl & 1) > 0)))
            & ((e1 > 0) | ((e1 == 0) & ((tl & 2) > 0)))
            & ((e2 > 0) | ((e2 == 0) & ((tl & 4) > 0)))
        )
        z = plane(S.CH_Z)
        zc = jnp.clip(z, 0.0, 1.0)
        zq = _round_half_even(zc * 65535.0) * _INV_Q if d16 else zc
        order = coeff(S.CH_ORDER)
        # z in [0, 1] iff clipping was a no-op (one compare; NaN fails)
        frag = cov & (z == zc) & in_scissor & live
        if le:
            passing = frag & ((zq < zbuf) | ((zq == zbuf) & (order >= obuf)))
        else:
            passing = frag & ((zq < zbuf) | ((zq == zbuf) & (order < obuf)))
        uwf = plane(S.CH_UW)
        vwf = plane(S.CH_VW)
        iwf = plane(S.CH_INVW)
        texf = meta & S.META_TEX_MASK
        if peel2:
            # Layer 2 is the depth-RECORD holder immediately before the
            # winner drew (the second-to-last SURVIVOR of the sequential
            # depth test) — NOT the global second-best (z, order): a
            # fragment drawn after the winner with greater z never blended
            # in exact mode.  Three rules keep the survivor invariant in
            # one streaming pass (lex comparisons reuse the depth tie
            # rule):
            #   * a non-winning fragment is a candidate only if drawn
            #     before the current winner (order < obuf)
            #   * on a winner change the old winner demotes only if drawn
            #     before the new one (obuf < order); otherwise the old
            #     layer 2 is kept only while still order-valid
            #     (o2 < order), else the slot keeps the old winner's
            #     (z, order) as a record GATE with own2 = -1
            #     (unshadeable): the true record is at least that deep,
            #     we just cannot name its fragment
            #   * z2 never increases, so the peel-aware early-exit bound
            #     (max over z2) stays sound
            # A gated/absent layer 2 shades as background — such pixels
            # fall back to single-layer semantics, never to a fragment
            # exact mode did not blend.
            valid2 = order < obuf
            if le:
                beats2 = (frag & ~passing & valid2
                          & ((zq < z2) | ((zq == z2) & (order >= o2))))
            else:
                beats2 = (frag & ~passing & valid2
                          & ((zq < z2) | ((zq == z2) & (order < o2))))
            demote = passing & (obuf < order)
            inval = passing & ~demote & ~(o2 < order)
            repl = demote | inval
            z2 = jnp.where(repl, zbuf, jnp.where(beats2, zq, z2))
            own2 = jnp.where(demote, owner,
                             jnp.where(inval, -1,
                                       jnp.where(beats2, eid, own2)))
            o2 = jnp.where(repl, obuf, jnp.where(beats2, order, o2))
            uw2 = jnp.where(repl, uwb, jnp.where(beats2, uwf, uw2))
            vw2 = jnp.where(repl, vwb, jnp.where(beats2, vwf, vw2))
            iw2 = jnp.where(repl, iwb, jnp.where(beats2, iwf, iw2))
            tex2 = jnp.where(repl, texb, jnp.where(beats2, texf, tex2))
        zbuf = jnp.where(passing, zq, zbuf)
        owner = jnp.where(passing, eid, owner)
        obuf = jnp.where(passing, order, obuf)
        uwb = jnp.where(passing, uwf, uwb)
        vwb = jnp.where(passing, vwf, vwb)
        iwb = jnp.where(passing, iwf, iwb)
        texb = jnp.where(passing, texf, texb)
        out = (zbuf, owner, obuf, uwb, vwb, iwb, texb)
        if peel2:
            out = out + (z2, own2, o2, uw2, vw2, iw2, tex2)
        return out

    layer0 = (
        jnp.full(shape, -1, jnp.int32),
        jnp.full(shape, -1.0, jnp.float32),
        jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape, jnp.float32),
        jnp.ones(shape, jnp.float32),
        jnp.zeros(shape, jnp.int32),
    )
    zb0 = depth_init_ref[...]
    state = (zb0,) + layer0
    if peel2:
        state = state + (zb0,) + layer0

    # Early-exit threshold: the max depth over the tile (peel2: over layer
    # 2, since an entry may still enter layer 2 while z2 >= z1 anywhere).
    # The stream is sorted ascending by the conservative CH_ZMIN bound and
    # deadness is monotone, so once a chunk's first entry is dead so is the
    # rest of the segment.  The chunk loop has a fixed trip count with a
    # carried ``alive`` flag: a dead chunk costs one load and one reduce.
    # (Every loop here is a counted loop: Triton lowers lax.while_loop to
    # scf.while, which fails to compile with refs in its carry.)
    zi = 7 if peel2 else 0
    nchunks = jnp.where(end > start, (end - start + chunk - 1) // chunk, 0)

    def entry_block(s, n_here):
        def body(jj, st):
            base = s + jj * _UNROLL
            for u in range(_UNROLL):
                i = base + u
                ic = jnp.minimum(i, e_cap - 1)
                st = resolve(lambda row, ic=ic: entries_ref[ic, row],
                             ic, i < s + n_here, st)
            return st
        return body

    def chunk_body(k, carry):
        alive, st = carry
        s = start + k * chunk
        proceed = (alive != 0) & (
            entries_ref[s, S.CH_ZMIN] * _INV_Q <= jnp.max(st[zi]))
        n_here = jnp.where(proceed, jnp.minimum(end - s, chunk), 0)
        st = jax.lax.fori_loop(
            0, (n_here + _UNROLL - 1) // _UNROLL, entry_block(s, n_here), st)
        return proceed.astype(jnp.int32), st

    _, state = jax.lax.fori_loop(
        0, nchunks, chunk_body, (jnp.int32(1), state))

    # broad entries: bbox test per entry, bounded by the live count
    if n_broad_cap > 0:
        def broad_body(j, st):
            live = ((gx >= broad_tiles_ref[j, 0]) & (gx <= broad_tiles_ref[j, 2])
                    & (gy >= broad_tiles_ref[j, 1]) & (gy <= broad_tiles_ref[j, 3]))
            return resolve(lambda row: broad_ch_ref[j, row],
                           owner_base + j, live, st)

        state = jax.lax.fori_loop(
            0, jnp.minimum(nbroad_ref[0], n_broad_cap), broad_body, state)

    # output order: (owner, z, order, uw, vw, iw, tex) per layer
    perm = (1, 0, 2, 3, 4, 5, 6)
    for li in range(2 if peel2 else 1):
        for k, p in enumerate(perm):
            out_refs[7 * li + k][...] = state[7 * li + p]


@functools.partial(
    jax.jit,
    static_argnames=(
        "fb_w", "fb_h", "tile_w", "tile_h", "grid_w", "grid_h",
        "chunk", "depth_state", "interpret", "peel2",
    ),
)
def rasterize_visibility_pallas(
    binned: BinnedEntries,
    init_depth,   # f32 [fb_h, fb_w]
    scissor,      # i32 [4] in frame coordinates
    row0=0,       # i32 [] frame row of the buffer's first row (a band)
    *,
    fb_w: int,
    fb_h: int,
    tile_w: int,
    tile_h: int,
    grid_w: int,
    grid_h: int,
    chunk: int = 32,
    depth_state: DepthState,
    interpret: bool = False,
    peel2: bool = False,
):
    """Visibility resolve. Returns (VisibilityBuffer, overflow=0); with
    peel2=True returns (VisibilityBuffer, layer2 VisibilityBuffer,
    overflow=0) — the depth-record holder before each pixel's winner, for
    the sequential-blend shade (ops/shade.py two-layer path).

    Unlike the XLA path there is no per-tile capacity (tiles walk their
    whole segment), so tile overflow cannot occur.  ``interpret`` runs the
    kernel through the Pallas interpreter (CPU tests); the caller decides
    it (rendering/passes.py::visibility_backend)."""
    if not kernel_supports(tile_w, tile_h, depth_state):
        raise NotImplementedError(
            "the visibility kernel needs power-of-two tile sides and depth "
            "test+write with LESS/LESS_OR_EQUAL; use the XLA path or exact "
            "mode")

    pad_h = grid_h * tile_h
    pad_w = grid_w * tile_w
    depth0 = jnp.pad(
        init_depth.astype(jnp.float32),
        ((0, pad_h - fb_h), (0, pad_w - fb_w)),
        constant_values=jnp.float32(-jnp.inf),  # nothing passes off-fb
    )
    e_cap = binned.entry_channels.shape[0]
    n_broad_cap = binned.broad_channels.shape[0]
    kernel = functools.partial(
        _visibility_kernel,
        tile_w=tile_w, tile_h=tile_h, grid_w=grid_w, chunk=chunk,
        e_cap=e_cap, n_broad_cap=n_broad_cap,
        # entry_tile is always sliced to the LOGICAL entry_cap
        owner_base=binned.entry_tile.shape[0],
        d16=depth_state.format == DepthFormat.D16_UNORM,
        le=depth_state.compare_op == CompareOp.LESS_OR_EQUAL,
        peel2=peel2,
    )
    # the broad arrays keep one row even when the list is empty: pallas
    # operands must not be zero-sized
    broad_ch = binned.broad_channels
    broad_tiles = binned.broad_tiles
    if n_broad_cap == 0:
        broad_ch = jnp.zeros((1, S.NUM_CHANNELS), jnp.float32)
        broad_tiles = jnp.zeros((1, 4), jnp.int32)

    whole = pl.BlockSpec(memory_space=pl.ANY)
    tile_block = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    layer = [jnp.int32] + [jnp.float32] * 5 + [jnp.int32]
    outs = pl.pallas_call(
        kernel,
        grid=(grid_h, grid_w),
        in_specs=[whole] * 6 + [tile_block],
        out_specs=[tile_block] * (14 if peel2 else 7),
        out_shape=[jax.ShapeDtypeStruct((pad_h, pad_w), dt)
                   for dt in layer * (2 if peel2 else 1)],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=max(1, min(8, tile_w * tile_h // 64)), num_stages=1),
        interpret=interpret,
        name="visibility_resolve",
    )(
        binned.tile_start,
        jnp.concatenate([scissor.astype(jnp.int32),
                         jnp.reshape(row0, (1,)).astype(jnp.int32)]),
        binned.num_broad.reshape(1),
        binned.entry_channels,
        broad_ch,
        broad_tiles,
        depth0,
    )

    def crop_vis(owner, z, order, uw, vw, iw, tex):
        return VisibilityBuffer(
            owner=owner[:fb_h, :fb_w],
            depth=z[:fb_h, :fb_w],
            order=order[:fb_h, :fb_w],
            uw=uw[:fb_h, :fb_w],
            vw=vw[:fb_h, :fb_w],
            iw=iw[:fb_h, :fb_w],
            tex=tex[:fb_h, :fb_w],
        )

    zero = jnp.zeros((), jnp.int32)
    vis = crop_vis(*outs[:7])
    if peel2:
        return vis, crop_vis(*outs[7:14]), zero
    return vis, zero
