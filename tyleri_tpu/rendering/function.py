"""RenderingFunction protocol (ref: src/rendering_function/mod.rs:14-26).

The reference's trait takes a device + swapchain at construction and records
one frame into a primary command buffer.  The analog here: construction
specializes/compiles the frame program for a target's resolution, and
``record`` turns a RenderScene into one jitted frame execution returning the
framebuffer (the "executable command buffer" is the XLA executable; async
dispatch is the submission).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import jax


class Frame(NamedTuple):
    """The recorded+submitted frame: device arrays still being computed
    (async dispatch), plus validation stats."""

    color: jax.Array          # f32 [H, W, 4]
    depth: jax.Array          # f32 [H, W]
    bin_overflow: jax.Array   # i32 []
    tile_overflow: jax.Array  # i32 []
    order: jax.Array          # f32 [H, W] global draw order of the pixel's
                              # winner (-1 = clear, 0 = UI, >=1 meshes);
                              # consumed by the cross-device depth composite
    clip_overflow: jax.Array = None  # i32 [] near-clip splits beyond capacity
    clip_crossings: jax.Array = None  # i32 [] near-plane crossings observed
    bin_demand: jax.Array = None      # i32 [] max live narrow triangles over
                                      # the frame's passes (dense-slot
                                      # demand; adaptive valid_cap feedback)
    entry_demand: jax.Array = None    # i32 [] max live placed entries over
                                      # the frame's passes (adaptive
                                      # entry-slice shrink feedback)
    spill_demand: jax.Array = None    # i32 [L] elementwise-max per-spill-
                                      # level triangle demand (adaptive
                                      # spill_level_caps fit feedback)
    color_u8: jax.Array = None        # u8 [H, W, 4] presentation image,
                                      # quantized INSIDE the frame program
                                      # (plan.present_u8) — one launch per
                                      # frame instead of two


class RenderingFunction(Protocol):
    def __init__(self, render_device, swapchain): ...

    def record(self, render_device, render_resources, scale_factor: float,
               window_size) -> Frame: ...
