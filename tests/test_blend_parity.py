"""Blend-parity "auto" policy (VERDICT r4 item 3): the reference's mesh
pipeline always blends in submission order (ref common_pipeline.rs:117-131);
the policy engages the two-layer depth peel by scene scale on the kernel
path, pins via "peel2"/"fast"/"exact", and reports the deviation through the
messenger exactly when the fast path ships for a blending scene.
"""

import dataclasses

import numpy as np
import pytest

import tyleri_tpu as ty
from tyleri_tpu.models import scenes as scenelib
from tyleri_tpu.rendering import forward
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.window.swapchain import ImageViewSwapchain

RES = (64, 64)


def _pallas_capable(rf):
    """Force the visibility kernel (interpret mode on the CPU) so the
    policy's GPU behavior is testable on the CPU suite."""
    rf.plan = dataclasses.replace(rf.plan, raster=dataclasses.replace(
        rf.plan.raster, pallas=True))


def _scene(dev, n_instances=6):
    rig = scenelib.config4_instances(dev, RES, n_instances=n_instances)
    scene = RenderScene()
    rig.fill(scene, 0.5)
    return scene


def _msgs(dev):
    out = []
    dev.debug_messenger.callback = lambda m: out.append(m.message_id)
    return out


def test_auto_engages_peel2_below_threshold_on_pallas_path():
    dev = ty.RenderDeviceBuilder().build()
    msgs = _msgs(dev)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    _pallas_capable(rf)
    scene = _scene(dev)
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert rf.plan.raster.peel2, "auto should engage peel2 for small scenes"
    assert "blend-order-deviation" not in msgs, "messenger silent when engaged"
    # ... and the engaged plan actually renders (interpret kernel)
    frame = forward._render_frame(
        rf.plan, rf.mesh_state, rf.ui_state,
        *rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES))
    assert np.asarray(frame.color)[..., :3].max() > 0


def test_auto_keeps_fast_path_above_threshold_and_warns_once(monkeypatch):
    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 8)
    dev = ty.RenderDeviceBuilder().validation_level(
        ty.ValidationLevel.WARNING).build()
    msgs = _msgs(dev)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    _pallas_capable(rf)
    scene = _scene(dev)  # ~hundreds of tris > 8
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert not rf.plan.raster.peel2
    assert msgs.count("blend-order-deviation") == 1
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert msgs.count("blend-order-deviation") == 1, "warn once, not per frame"


def test_auto_stays_fast_on_xla_path_and_warns():
    """On the XLA path (CPU default; unsupported depth states on a GPU) the
    peel2 flag would be inert — the plan stays stable and the deviation is
    reported instead."""
    dev = ty.RenderDeviceBuilder().validation_level(
        ty.ValidationLevel.WARNING).build()
    msgs = _msgs(dev)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    scene = _scene(dev)
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert not rf.plan.raster.peel2
    assert msgs.count("blend-order-deviation") == 1


def test_blend_parity_pinned_modes():
    dev = ty.RenderDeviceBuilder().build()
    # "peel2" pins on at construction, regardless of scale
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES),
                                     blend_parity="peel2")
    assert rf.plan.raster.peel2
    scene = _scene(dev)
    rf.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert rf.plan.raster.peel2, "pinned peel2 must survive the frame plan"
    # "fast" never engages, even below threshold on a capable plan
    rf_fast = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES),
                                          blend_parity="fast")
    _pallas_capable(rf_fast)
    rf_fast.build_frame_inputs(dev, scene.render_resources, 1.0, RES)
    assert not rf_fast.plan.raster.peel2
    # "exact" is the bit-parity mode
    rf_exact = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES),
                                           blend_parity="exact")
    assert rf_exact.plan.raster.exact
    with pytest.raises(ValueError):
        ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES),
                                    blend_parity="bogus")


def test_env_knob_overrides_auto(monkeypatch):
    dev = ty.RenderDeviceBuilder().build()
    monkeypatch.setenv("TYLERI_PEEL2", "0")
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    assert rf.blend_parity == "fast"
    monkeypatch.setenv("TYLERI_PEEL2", "1")
    rf2 = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(RES))
    assert rf2.blend_parity == "peel2" and rf2.plan.raster.peel2


def test_peel2_composes_with_lit_single_layer():
    """peel2 + lit shading: on geometry with no overlap, layer 2 is empty
    everywhere and the peel2 frame must match the single-layer lit frame
    pixel-for-pixel (guards suzanne-class lit scenes, which the auto
    policy runs with peel2 on a GPU)."""
    res = (96, 96)
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config3_suzanne(dev, resolution=res)

    def render(peel2):
        rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(res),
                                         blend_parity="peel2" if peel2
                                         else "fast")
        rf.plan = dataclasses.replace(rf.plan, raster=dataclasses.replace(
            rf.plan.raster, pallas=True, peel2=peel2))
        scene = RenderScene()
        rig.fill(scene, 0.3)
        arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
        frame = forward._render_frame(rf.plan, rf.mesh_state, rf.ui_state,
                                      *arrays)
        return np.asarray(frame.color), np.asarray(frame.depth)

    c_fast, d_fast = render(False)
    c_p2, d_p2 = render(True)
    assert (c_fast[..., :3] > 0).any(), "sanity: lit sphere visible"
    np.testing.assert_array_equal(d_p2, d_fast)
    # the sphere is closed with cull NONE: every covered pixel has a back
    # face behind the front face, so layer 2 EXISTS and blends — restrict
    # the equality claim to what single-layer semantics guarantee: the
    # depth buffer and the uncovered background
    bg = d_fast == 1.0
    np.testing.assert_array_equal(c_p2[bg], c_fast[bg])
