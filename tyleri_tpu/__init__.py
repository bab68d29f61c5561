"""tyleri_tpu — a software rasterization framework in JAX.

A ground-up re-design of the capabilities of ``ping-pong-room/tyleri-renderer``
(a Rust/Vulkan forward renderer) for an accelerator without fixed-function
raster hardware, here an NVIDIA GPU: the compute path is JAX/XLA plus one
Pallas kernel (Triton route), scaling is ``jax.sharding`` over device meshes,
and the per-frame hot loop is a jitted visibility-buffer rasterizer.

Layer map (mirrors reference ``src/lib.rs:15-21`` module layout):

  L0 device/     RenderDevice + RenderDeviceBuilder  (ref: src/render_device*)
  L1 resource/   arenas, allocator, upload API       (ref: src/resource/)
  L2 pipeline/   pipeline state + shader equivalents (ref: src/pipeline/)
  LK ops/        Pallas/XLA kernels (the "fixed function" hardware)
  L3 rendering/  RenderingFunction protocol + forward(ref: src/rendering_function/)
  L4 scene/      Camera, MeshRenderer, UI, RenderScene (ref: src/render_scene.rs,
                 src/render_objects/)
  L5 window/     swapchain ring + RenderWindow        (ref: src/render_window*)
  parallel/      multi-card tile/draw sharding (no reference analog)
  models/        built-in geometry + the 5 BASELINE scene configs
  testing/       numpy oracle rasterizer implementing Vulkan raster rules

The only top-level re-export of the reference is ``ForwardRenderingFunction``
(ref: src/lib.rs:13); we re-export the full public API for convenience.
Imports are lazy so that partial installs / tooling can import the package
root cheaply.
"""

import importlib

__version__ = "0.1.0"

# public name -> module path
_EXPORTS = {
    "Vertex": "tyleri_tpu.api.vertex",
    "UIVertex": "tyleri_tpu.api.vertex",
    "LitVertex": "tyleri_tpu.api.vertex",
    "DirectionalLight": "tyleri_tpu.scene.light",
    "RenderDeviceBuilder": "tyleri_tpu.device.builders",
    "ValidationLevel": "tyleri_tpu.device.builders",
    "RenderDevice": "tyleri_tpu.device.render_device",
    "BlendFactor": "tyleri_tpu.pipeline.state",
    "BlendOp": "tyleri_tpu.pipeline.state",
    "BlendState": "tyleri_tpu.pipeline.state",
    "CompareOp": "tyleri_tpu.pipeline.state",
    "CullMode": "tyleri_tpu.pipeline.state",
    "DepthFormat": "tyleri_tpu.pipeline.state",
    "DepthState": "tyleri_tpu.pipeline.state",
    "FrontFace": "tyleri_tpu.pipeline.state",
    "MESH_PIPELINE_STATE": "tyleri_tpu.pipeline.state",
    "PipelineState": "tyleri_tpu.pipeline.state",
    "RasterState": "tyleri_tpu.pipeline.state",
    "UI_PIPELINE_STATE": "tyleri_tpu.pipeline.state",
    "ForwardRenderingFunction": "tyleri_tpu.rendering.forward",
    "RenderingFunction": "tyleri_tpu.rendering.function",
    "Camera": "tyleri_tpu.scene.camera",
    "MeshRenderer": "tyleri_tpu.scene.mesh_renderer",
    "RenderScene": "tyleri_tpu.scene.render_scene",
    "Rect2D": "tyleri_tpu.utils.math3d",
    "Viewport": "tyleri_tpu.utils.math3d",
    "RenderWindow": "tyleri_tpu.window.render_window",
    "WindowHandle": "tyleri_tpu.window.render_window",
    "CommonPipeline": "tyleri_tpu.pipeline.common_pipeline",
    "UIPipeline": "tyleri_tpu.pipeline.ui_pipeline",
    "UIElement": "tyleri_tpu.scene.ui",
    "ParallelGroup": "tyleri_tpu.scene.parallel_group",
    "FrameProfiler": "tyleri_tpu.utils.profiling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'tyleri_tpu' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
