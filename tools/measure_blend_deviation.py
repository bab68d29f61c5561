"""Quantify the visibility path's blend-order deviation on the BASELINE
configs (VERDICT r2 item 7).

The mesh pipeline enables the reference's odd SrcColor/OneMinusDstColor
blend (pipeline/state.py:114-131).  The visibility path blends only the
FINAL visible fragment against the pre-pass framebuffer, while exact mode
reproduces Vulkan's per-fragment sequential blending — with overdraw the
two accumulate differently.  This renders configs 4/5 at reduced
resolution through both paths on the same device and reports the u8
deviation.  Run on a GPU (peel2 needs the visibility kernel):
    python tools/measure_blend_deviation.py
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def render(device, rig, *, exact: bool, peel2: bool = False):
    import tyleri_tpu as ty
    from tyleri_tpu.scene.render_scene import RenderScene
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    # pin the policy: the blend-parity "auto" default would itself engage
    # peel2 at these scene scales, contaminating the "fast" row
    rf = ty.ForwardRenderingFunction(
        device, ImageViewSwapchain(rig.resolution), exact=exact,
        blend_parity="peel2" if peel2 else "fast")
    if exact:
        # exact mode scans per-tile fragment lists: give the reduced-res
        # grid generous per-tile capacity so nothing truncates
        rf.plan = dataclasses.replace(
            rf.plan,
            raster=dataclasses.replace(rf.plan.raster, cap_per_tile=16384),
        )
    if peel2:
        rf.plan = dataclasses.replace(
            rf.plan,
            raster=dataclasses.replace(rf.plan.raster, peel2=True),
        )
    frame = None
    for _ in range(6):
        scene = RenderScene()
        rig.fill(scene, 0.5)
        frame = rf.record(device, scene.render_resources, 1.0, rig.resolution)
        over = int(jax.device_get(frame.bin_overflow))
        tile_over = int(jax.device_get(frame.tile_overflow))
        clip_over = int(jax.device_get(frame.clip_overflow))
        if over == 0 and tile_over == 0 and clip_over == 0:
            break
        rf.note_overflow(over, tile_over, clip_over)
    assert int(jax.device_get(frame.tile_overflow)) == 0, "tile overflow"
    color = np.asarray(jax.device_get(frame.color))
    return np.clip(np.round(color * 255.0), 0, 255).astype(np.uint8)


def main():
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib

    device = ty.RenderDeviceBuilder().build()
    print("device:", device.device)
    rigs = [
        scenelib.config4_instances(device, resolution=(480, 272)),
        scenelib.config5_sponza(device, resolution=(480, 272), grid_n=132),
    ]
    for rig in rigs:
        b = render(device, rig, exact=True)
        for label, kw in (("fast", {}), ("peel2", dict(peel2=True))):
            a = render(device, rig, exact=False, **kw)
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            bad = int((diff > 1).sum())
            print(f"{rig.name} ({rig.triangle_count} tris) {label}: "
                  f"max|diff|={int(diff.max())}u8 "
                  f"pixels>1u8={bad} ({100.0 * bad / diff.size:.3f}%) "
                  f"mean|diff|={diff.mean():.4f}u8")


if __name__ == "__main__":
    main()
