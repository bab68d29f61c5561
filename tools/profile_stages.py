"""Per-layer timing of the frame program and the visibility A/B on one GPU.

For each scene it prints, on the host clock around work fenced with
block_until_ready (mean over the timed repetitions):

* the layers of one camera pass as separately jitted stages: transform,
  near-clip, plane setup, binning, visibility through the kernel and
  through the XLA reference (ops/visibility.py), deferred shade
* end-to-end FPS of the production RenderWindow loop with the visibility
  kernel and with the XLA path, in turns (kernel, xla, xla, kernel) so that
  drift on the card shows in the spread

With ``--tiles`` it also sweeps the screen tile shape (binning and kernel
together) and times the layers and the whole frame per shape.  With
``--trace`` the visibility stage of both backends is also timed as device
busy time in a jax.profiler trace.

    python tools/profile_stages.py [--tiles] [--trace] [--reps N] [scene ...]

Scenes: cube, suzanne, instances, sponza (default: sponza instances).
Every line names the card and its power limit; without a GPU it exits 1.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timeit(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def device_busy_ms(fn, *args, reps=10):
    """Device busy time per call from a profiler trace: the union of the
    GPU planes' stream-line event intervals over ``reps`` calls, divided by
    ``reps``.  Returns (ms, {line names}, [(kernel, ms per call), ...])."""
    import collections
    import glob
    import tempfile

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(__file__)) as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        (path,) = glob.glob(os.path.join(d, "plugins/profile/*/*.xplane.pb"))
        data = jax.profiler.ProfileData.from_file(path)
        spans, lines, per_kernel = [], set(), collections.Counter()
        for plane in data.planes:
            if "/device:GPU" not in plane.name:
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                lines.add(line.name)
                for e in line.events:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
                    per_kernel[e.name] += e.duration_ns
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = [(k, round(v / reps / 1e6, 4)) for k, v in per_kernel.most_common(3)]
    return busy / reps / 1e6, sorted(lines), top


def stage_times(device, rig, plan_kw, reps, trace=False):
    """ms per layer of one camera pass (first camera) under the scene's
    production plan, with ``plan_kw`` overrides (e.g. tile shape)."""
    import tyleri_tpu as ty
    from tyleri_tpu.ops.binning import bin_triangles
    from tyleri_tpu.ops.clip import near_clip_triangles
    from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
    from tyleri_tpu.ops.setup import setup_triangles, transform_corner_table
    from tyleri_tpu.ops.shade import shade_visibility
    from tyleri_tpu.ops.visibility import rasterize_visibility
    from tyleri_tpu.rendering.forward import _render_frame
    from tyleri_tpu.testing.smoke import binned_pass
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    rf = ty.ForwardRenderingFunction(
        device, ImageViewSwapchain(rig.resolution), blend_parity="fast")
    if plan_kw:
        rf.plan = dataclasses.replace(
            rf.plan, raster=dataclasses.replace(rf.plan.raster, **plan_kw))
    arrays, binned = binned_pass(rf, device, rig)
    arrays = jax.device_put(arrays)
    r = rf.plan.raster
    state = rf.mesh_state
    (texels, toff, tw, th, _clear, cam_valid, viewports, scissors,
     view_projs, models, corners, tri_draw, tri_valid0, tri_tex, *_) = arrays

    @jax.jit
    def transform(view_projs, models):
        mvps = jnp.einsum("ij,djk->dik", view_projs[0], models[0],
                          precision=jax.lax.Precision.HIGHEST)
        return transform_corner_table(corners[0], tri_draw[0], mvps)

    @jax.jit
    def clip(c, uv):
        return near_clip_triangles(c, uv, tri_tex[0],
                                   tri_valid0[0] & cam_valid[0],
                                   extra_cap=r.clip_cap)

    @jax.jit
    def planes(ct):
        return setup_triangles(
            ct.clip, ct.uv, ct.tex_id, ct.valid, viewports[0], scissors[0],
            tile_w=r.tile_w, tile_h=r.tile_h, grid_w=r.grid_w,
            grid_h=r.grid_h, order=ct.order)

    @jax.jit
    def setup_all(view_projs, models):
        return planes(clip(*transform(view_projs, models)))

    @jax.jit
    def binning(su):
        return bin_triangles(
            su, grid_w=r.grid_w, grid_h=r.grid_h, entry_cap=r.entry_cap,
            max_tiles_per_tri=r.max_tiles_per_tri, broad_cap=r.broad_cap,
            spill_cap=r.spill_cap, valid_cap=r.valid_cap,
            spill_level_caps=r.spill_level_caps)

    depth0 = jnp.ones((r.fb_h, r.fb_w), jnp.float32)
    geom = dict(fb_w=r.fb_w, fb_h=r.fb_h, tile_w=r.tile_w, tile_h=r.tile_h,
                grid_w=r.grid_w, grid_h=r.grid_h, chunk=r.chunk,
                depth_state=state.depth)
    counts = jnp.diff(binned.tile_start)
    cap = int(max(r.cap_per_tile, -(-int(counts.max()) // r.chunk) * r.chunk))

    @jax.jit
    def vis_kernel(binned, depth0):
        return rasterize_visibility_pallas(binned, depth0, scissors[0], **geom)

    @jax.jit
    def vis_xla(binned, depth0):
        return rasterize_visibility(binned, depth0, scissors[0],
                                    cap_per_tile=cap, **geom)

    @jax.jit
    def shade(vis):
        color0 = jnp.zeros((r.fb_h, r.fb_w, 4), jnp.float32)
        return shade_visibility(vis, texels, toff, tw, th, state.blend, color0)

    c, uv = transform(view_projs, models)
    ct = clip(c, uv)
    su = planes(ct)
    vis, _ = vis_kernel(binned, depth0)
    out = {
        "tile": f"{r.tile_w}x{r.tile_h}",
        "entries": int(binned.num_entries),
        "max_tile_entries": int(counts.max()),
        "transform_ms": timeit(transform, view_projs, models, reps=reps),
        "clip_ms": timeit(clip, c, uv, reps=reps),
        "planes_ms": timeit(planes, ct, reps=reps),
        "setup_ms": timeit(setup_all, view_projs, models, reps=reps),
        "binning_ms": timeit(binning, su, reps=reps),
        "vis_kernel_ms": timeit(vis_kernel, binned, depth0, reps=reps),
        "vis_xla_ms": timeit(vis_xla, binned, depth0, reps=reps),
        "shade_ms": timeit(shade, vis, reps=reps),
    }
    if trace:
        for name, fn in (("vis_kernel", vis_kernel), ("vis_xla", vis_xla)):
            ms, lines, top = device_busy_ms(fn, binned, depth0, reps=reps)
            out[f"{name}_trace_busy_ms"] = ms
            out[f"{name}_trace_top"] = top
            out["trace_lines"] = lines
    for name, pallas in (("frame_kernel_ms", "auto"), ("frame_xla_ms", False)):
        p = dataclasses.replace(rf.plan, raster=dataclasses.replace(
            r, pallas=pallas, cap_per_tile=cap))
        out[name] = timeit(
            lambda *a, p=p: _render_frame(p, rf.mesh_state, rf.ui_state, *a),
            *arrays, reps=reps)
    return out


def window_fps(device, rig, *, pallas, blend_parity="auto", frames=32):
    """Steady-state FPS of the production RenderWindow loop: warm up,
    settle the adaptive plan (each plan change recompiles), then time
    ``frames`` frames fenced by the window's flush."""
    from tyleri_tpu.window.render_window import RenderWindow, WindowHandle

    win = RenderWindow(device, WindowHandle(), resolution=rig.resolution,
                       present_mode="immediate", blend_parity=blend_parity)
    rf = win.rendering_function
    rf.plan = dataclasses.replace(
        rf.plan, raster=dataclasses.replace(rf.plan.raster, pallas=pallas))

    def frame(t):
        rig.fill(win.get_render_scene(), t)
        win.render(device)

    prev = None
    for j in range(8):
        if rf.plan == prev:
            break
        prev = rf.plan
        for i in range(8):
            frame(0.1 * (8 * j + i))
        win.flush()
    t0 = time.perf_counter()
    for k in range(frames):
        frame(1.0 + 0.05 * k)
    win.flush()
    dt = time.perf_counter() - t0
    return frames / dt, rf.plan.raster.peel2, rf.plan == prev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="*", default=["sponza", "instances"])
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-window", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="also trace the visibility stage of both backends")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_stages times the GPU only; no GPU found")
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib

    smi = card()
    print(f"card: {smi}; jax {jax.__version__}", flush=True)
    device = ty.RenderDeviceBuilder().build()
    makers = {
        "cube": lambda: scenelib.config2_cube(device, (800, 600)),
        "suzanne": lambda: scenelib.config3_suzanne(device),
        "instances": lambda: scenelib.config4_instances(device),
        "sponza": lambda: scenelib.config5_sponza(device),
    }
    for name in args.scenes:
        rig = makers[name]()
        shapes = ([(16, 16), (32, 8), (8, 32), (32, 16)]
                  if args.tiles else [None])
        for shape in shapes:
            kw = dict(tile_w=shape[0], tile_h=shape[1]) if shape else {}
            r = stage_times(device, rig, kw, args.reps,
                            trace=args.trace and shape in (None, (16, 16)))
            print(json.dumps({"scene": rig.name, "card": smi, **{
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in r.items()}}), flush=True)
        if args.no_window:
            continue
        variants = [("kernel", "auto", "auto"), ("xla", False, "auto")]
        if name == "instances":
            variants.append(("kernel_fast", "auto", "fast"))
        for label, pallas, bp in variants + variants[::-1]:
            fps, peel2, settled = window_fps(
                device, rig, pallas=pallas, blend_parity=bp)
            print(json.dumps({"scene": rig.name, "card": smi,
                              "window": label, "fps": round(fps, 3),
                              "peel2": peel2, "plan_settled": settled}),
                  flush=True)


if __name__ == "__main__":
    main()
