"""Device-mesh construction for multi-chip rendering.

The reference is strictly single-GPU; its only parallelism is threads over
draw recording (SURVEY §2 "Parallelism").  The scaling axes are:

* ``tiles`` — sort-first image parallelism: each device owns a horizontal
  band of the framebuffer tile grid (the classic sort-first taxonomy; the
  SP/CP analog: the screen is the long axis).
* ``draws`` — sort-last object parallelism: each device rasterizes a subset
  of draws at full resolution, composited by depth (the DP analog; the
  round-robin ParallelGroup partitioning of the reference mapped onto
  devices instead of threads, ref: src/render_objects/mod.rs:5-30).

Both axes combine into a 2-D mesh (draws, tiles); collectives ride NVLink:
the composite is pmin/pmax/psum reductions over the ``draws`` axis whose
per-device traffic is O(band size), independent of the draws-axis length.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

AXIS_DRAWS = "draws"
AXIS_TILES = "tiles"


def make_render_mesh(n_draw_shards: int = 1, devices=None) -> Mesh:
    """2-D (draws, tiles) mesh over the given devices (default: all)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % n_draw_shards != 0:
        raise ValueError(f"{n} devices not divisible by {n_draw_shards} draw shards")
    arr = np.array(devices).reshape(n_draw_shards, n // n_draw_shards)
    return Mesh(arr, (AXIS_DRAWS, AXIS_TILES))
