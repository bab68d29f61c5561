"""Depth-format quantization.

The reference renders against a D16_UNORM depth attachment
(ref: src/render_device/builders.rs:31, forward_rendering/mod.rs:132): depth
values are stored as 16-bit unsigned-normalized.  For pixel parity we quantize
interpolated depth onto the same grid before comparison; the framebuffer keeps
f32 storage but only ever holds representable D16 values.
"""

from __future__ import annotations

import jax.numpy as jnp

from tyleri_tpu.pipeline.state import DepthFormat


def quantize_depth(z, fmt: DepthFormat):
    """Quantize clamped window-space depth ``z`` to ``fmt``'s grid.

    Vulkan clamps fragment depth to the viewport depth range before the test;
    both reference pipelines use [0,1] bounds, so we clamp to [0,1] and
    round-to-nearest-even onto the UNORM grid for D16.
    """
    z = jnp.clip(jnp.asarray(z, jnp.float32), 0.0, 1.0)
    if fmt == DepthFormat.D32_SFLOAT:
        return z
    scale = jnp.float32(65535.0)
    return jnp.round(z * scale) / scale
