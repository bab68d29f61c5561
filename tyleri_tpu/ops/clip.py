"""Near-plane clipping with static shapes.

Vulkan clips primitives against z_c >= 0 and w > 0 (the near plane).  For
triangles entirely in front (w > eps for all vertices), per-pixel z-bound
tests reproduce z clipping exactly, so the only primitive-level work is the
w <= eps crossing:

  #inside | result
  --------+--------------------------------------------
     3    | unchanged
     2    | quad -> the in-place triangle + ONE extra triangle
     1    | clipped triangle, rewritten in place
     0    | culled

Design: crossing triangles are COMPACTED into a small work set of
``extra_cap`` slots first, and all rotate/lerp math runs on those rows only.
Rationale: a traced ``lax.cond`` around the heavy path gets flattened to a
select by XLA whenever it feels like it (both branches execute, with zero
crossings too), while mask + cumsum + a 256-row gather/scatter is O(T)
cheap ops + O(extra_cap) math.

Work-set slots hold both the in-place rewrite and (for n_in == 2) the extra
triangle, so one capacity bounds both.  A crossing triangle beyond capacity
is *culled and counted* in ``overflow`` (reported to the validation layer,
never rendered unclipped — the plan invariant).

Both halves of a split carry the ORIGINAL draw order, so depth-tie
resolution in the visibility rasterizer is unaffected.  Attributes
interpolate linearly in clip space (Vulkan spec 27.4), exactly like the
oracle's Sutherland-Hodgman (testing/oracle.py::clip_triangle).

We clip against the actual near plane z_c >= 0: for standard perspective
projections (w_c = -z_view), every post-clip vertex then has
w_c >= z_near > 0, so projected coordinates are well conditioned and the
remaining clip planes are equivalent to the rasterizer's per-pixel
z in [0, 1] + scissor tests.  (Pathological projective matrices that leave
w <= 0 after the near clip fall back to whole-triangle culling in setup.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

W_EPS = 1e-6


class ClippedTriangles(NamedTuple):
    clip: jax.Array      # f32 [T + X, 3, 4]
    uv: jax.Array        # f32 [T + X, 3, 2]
    tex_id: jax.Array    # i32 [T + X]
    valid: jax.Array     # bool [T + X]
    order: jax.Array     # f32 [T + X] original draw order per triangle
    overflow: jax.Array  # i32 [] crossing triangles culled (capacity)
    crossings: jax.Array = None  # i32 [] TOTAL near-plane crossings seen
                                 # (feeds the adaptive clip-skip feedback)


def clip_work_set(cr0, ur0):
    """The rotate/lerp core of the near-plane clip on an X-slot work set
    of crossing triangles (module docstring case table).  Returns
    (main_c, main_u, extra_c, extra_u, n_in): the in-place rewritten
    triangle, the extra second-quad-half triangle (meaningful when
    n_in == 2), and the recomputed inside count per slot.  Shared
    verbatim by near_clip_triangles (full-table compaction) and the
    fused-setup hybrid's crossing subset
    (rendering/passes.py::_fused_clip_subset)."""
    sr0 = cr0[..., 2]
    ins = sr0 >= 0.0
    nin = jnp.sum(ins.astype(jnp.int32), axis=1)

    # Rotate vertices so the case pattern is canonical, preserving winding
    # (cyclic): n_in == 1 -> the inside vertex at slot 0; n_in == 2 -> the
    # outside vertex at slot 2.
    ins_idx = jnp.argmax(ins, axis=1)
    out_idx = jnp.argmax(~ins, axis=1)
    r = jnp.where(nin == 1, ins_idx, (out_idx + 1) % 3)
    sel1 = (r == 1)[:, None, None]
    sel2 = (r == 2)[:, None, None]

    def rotate(a):
        a1 = jnp.concatenate([a[:, 1:3], a[:, 0:1]], axis=1)
        a2 = jnp.concatenate([a[:, 2:3], a[:, 0:2]], axis=1)
        return jnp.where(sel1, a1, jnp.where(sel2, a2, a))

    cr = rotate(cr0)
    ur = rotate(ur0)
    sr = cr[..., 2]

    def lerp_vertex(a_idx, b_idx):
        """Intersection of edge (a -> b) with the z_c = 0 plane."""
        sa = sr[:, a_idx]
        sb = sr[:, b_idx]
        denom = jnp.where(sb - sa == 0, 1.0, sb - sa)
        t = jnp.clip((0.0 - sa) / denom, 0.0, 1.0)[:, None]
        c = cr[:, a_idx] + t * (cr[:, b_idx] - cr[:, a_idx])
        u = ur[:, a_idx] + t * (ur[:, b_idx] - ur[:, a_idx])
        return c, u

    i01c, i01u = lerp_vertex(0, 1)
    i12c, i12u = lerp_vertex(1, 2)
    i20c, i20u = lerp_vertex(2, 0)

    # in-place triangle per case
    case1_c = jnp.stack([cr[:, 0], i01c, i20c], axis=1)
    case1_u = jnp.stack([ur[:, 0], i01u, i20u], axis=1)
    case2_c = jnp.stack([cr[:, 0], cr[:, 1], i12c], axis=1)
    case2_u = jnp.stack([ur[:, 0], ur[:, 1], i12u], axis=1)
    is1 = (nin == 1)[:, None, None]
    main_c = jnp.where(is1, case1_c, case2_c)
    main_u = jnp.where(is1, case1_u, case2_u)

    # extra triangle (second half of the quad) for n_in == 2
    extra_c = jnp.stack([cr[:, 0], i12c, i20c], axis=1)
    extra_u = jnp.stack([ur[:, 0], i12u, i20u], axis=1)
    return main_c, main_u, extra_c, extra_u, nin


@functools.partial(jax.jit, static_argnames=("extra_cap",))
def near_clip_triangles(clip, uv, tex_id, valid, *, extra_cap: int) -> ClippedTriangles:
    T = clip.shape[0]
    X = extra_cap
    order = jnp.arange(T, dtype=jnp.float32)

    s = clip[..., 2]                      # [T, 3] signed distance: z_c >= 0
    inside = s >= 0.0
    n_in = jnp.sum(inside.astype(jnp.int32), axis=1)
    needs = valid & (n_in > 0) & (n_in < 3)

    # ---- compact crossing triangles into the X-slot work set ----
    # (inverse lookup by searchsorted: slot k holds the k-th crossing
    # triangle; a [T] scatter would pay per-row latency at 1M+ triangles)
    ncum = jnp.cumsum(needs.astype(jnp.int32))
    n_needs = ncum[-1] if T > 0 else jnp.zeros((), jnp.int32)
    # binary search (the default 'scan' method): log2(T) rounds of X-row
    # gathers.  X is kept small by occupancy growth (FramePlan.clip_cap), so
    # this beats method='sort', which sorts the T+X concatenation (~19 ms at
    # 2M triangles regardless of X).
    src = jnp.searchsorted(
        ncum, jnp.arange(1, X + 1, dtype=jnp.int32), side="left",
    ).astype(jnp.int32)
    live = src < T
    src_c = jnp.clip(src, 0, max(T - 1, 0))

    cr0 = clip[src_c]                     # [X, 3, 4] row gathers
    ur0 = uv[src_c]                       # [X, 3, 2]
    main_c, main_u, extra_c, extra_u, nin = clip_work_set(cr0, ur0)

    # write the rewritten triangles back into their original slots
    # (an X-row scatter; draw order is untouched)
    clip_out = clip.at[jnp.where(live, src_c, T)].set(main_c, mode="drop")
    uv_out = uv.at[jnp.where(live, src_c, T)].set(main_u, mode="drop")

    xo = order[src_c]
    xv = live & (nin == 2)
    xt = jnp.where(xv, tex_id[src_c], 0)

    # crossing triangles beyond work capacity are culled + reported
    processed = needs & (ncum <= X)
    main_valid = valid & (n_in > 0) & (~needs | processed)
    overflow = jnp.maximum(n_needs - X, 0)

    return ClippedTriangles(
        clip=jnp.concatenate([clip_out, extra_c]),
        uv=jnp.concatenate([uv_out, extra_u]),
        tex_id=jnp.concatenate([tex_id, xt]),
        valid=jnp.concatenate([main_valid, xv]),
        order=jnp.concatenate([order, xo]),
        overflow=overflow.astype(jnp.int32),
        crossings=n_needs.astype(jnp.int32),
    )
