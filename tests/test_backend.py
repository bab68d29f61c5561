"""The one visibility-backend decision, the kernel's envelope and padding,
the XLA setup path, and the entry scripts' refusal to time a non-GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tyleri_tpu.ops import raster_pallas
from tyleri_tpu.pipeline.state import (
    MESH_PIPELINE_STATE,
    CompareOp,
    CullMode,
    FrontFace,
)
from tyleri_tpu.rendering import passes
from tyleri_tpu.utils.math3d import Rect2D, Viewport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALWAYS = dataclasses.replace(
    MESH_PIPELINE_STATE, depth=dataclasses.replace(
        MESH_PIPELINE_STATE.depth, compare_op=CompareOp.ALWAYS))


@pytest.mark.parametrize("platform,pallas,state,want", [
    ("gpu", "auto", MESH_PIPELINE_STATE, "kernel"),
    ("gpu", True, MESH_PIPELINE_STATE, "kernel"),
    ("gpu", False, MESH_PIPELINE_STATE, "xla"),
    ("gpu", "auto", ALWAYS, "xla"),
    ("cpu", "auto", MESH_PIPELINE_STATE, "xla"),
    ("cpu", True, MESH_PIPELINE_STATE, "interpret"),
    ("cpu", False, MESH_PIPELINE_STATE, "xla"),
], ids=["gpu-auto", "gpu-forced", "gpu-off", "gpu-always-depth",
        "cpu-auto", "cpu-forced", "cpu-off"])
def test_visibility_backend_choice(monkeypatch, platform, pallas, state, want):
    """gpu -> compiled kernel, cpu -> XLA, pallas=True on the CPU -> the
    interpreter; a depth state outside the kernel routes to XLA."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    plan = passes.RasterPlan.for_scene(64, 48, 256, pallas=pallas)
    assert passes.visibility_backend(plan, state) == want


def test_gpu_frame_never_interprets(monkeypatch):
    """On a GPU the mesh pass calls the kernel compiled (interpret=False),
    also when the plan forces it; nothing falls back silently."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    seen = []

    class Stop(Exception):
        pass

    def fake_kernel(*args, **kw):
        seen.append(kw["interpret"])
        raise Stop

    monkeypatch.setattr(raster_pallas, "rasterize_visibility_pallas",
                        fake_kernel)
    for pallas in ("auto", True):
        plan = passes.RasterPlan.for_scene(32, 32, 16, pallas=pallas)
        with pytest.raises(Stop):
            _mesh_pass(plan, *_random_tris(np.random.default_rng(0), 4))
    assert seen == [False, False]


def test_kernel_supports_envelope():
    ds = MESH_PIPELINE_STATE.depth
    assert raster_pallas.kernel_supports(16, 16, ds)
    assert raster_pallas.kernel_supports(32, 8, ds)
    assert not raster_pallas.kernel_supports(12, 16, ds)   # not pow2
    assert not raster_pallas.kernel_supports(16, 16, ALWAYS.depth)
    no_write = dataclasses.replace(ds, write_enable=False)
    assert not raster_pallas.kernel_supports(16, 16, no_write)
    # the production tile is the kernel's tile, on every backend
    plan = passes.RasterPlan.for_scene(1920, 1080, 1 << 20)
    assert (plan.tile_w, plan.tile_h) == (passes.TILE_W, passes.TILE_H)
    assert raster_pallas.kernel_supports(plan.tile_w, plan.tile_h, ds)


def test_round_half_even_matches_jnp_round():
    """The kernel's floor-based rounding equals jnp.round on the whole D16
    grid scale, ties included (the Triton route has no round primitive)."""
    k = np.arange(65536, dtype=np.float32)
    rng = np.random.default_rng(5)
    x = np.concatenate([
        k, k + 0.5, k - 0.5, k + 0.25,
        rng.uniform(0, 1, 100000).astype(np.float32) * 65535.0,
    ]).astype(np.float32)
    x = np.clip(x, 0, 65535)
    got = np.asarray(jax.jit(raster_pallas._round_half_even)(x))
    np.testing.assert_array_equal(got, np.round(x))


def _random_tris(rng, T):
    clip = np.zeros((T, 3, 4), np.float32)
    clip[..., :2] = rng.uniform(-1.1, 1.1, (T, 3, 2))
    clip[..., 2] = rng.integers(1, 63, (T, 1)) / 64.0
    clip[..., 3] = 1.0
    uv = rng.random((T, 3, 2)).astype(np.float32)
    return clip, uv


def _mesh_pass(plan, clip, uv, state=MESH_PIPELINE_STATE):
    T = clip.shape[0]
    W, H = plan.fb_w, plan.fb_h
    texels = jnp.asarray(np.random.default_rng(1).random((16, 16)),
                         jnp.float32)
    meta = (jnp.zeros((1,), jnp.int32), jnp.full((1,), 4, jnp.int32),
            jnp.full((1,), 4, jnp.int32))
    c, d, st, _ = passes.mesh_pass(
        plan, state, jnp.zeros((H, W, 4), jnp.float32),
        jnp.ones((H, W), jnp.float32), jnp.asarray(clip), jnp.asarray(uv),
        jnp.zeros((T,), jnp.int32), jnp.ones((T,), bool),
        Viewport(0, 0, W, H).as_array(), Rect2D(0, 0, W, H).as_array(),
        texels, *meta)
    return np.asarray(c), np.asarray(d), st


@pytest.mark.parametrize("size", [(40, 24), (33, 17), (70, 50)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_pads_frames_not_multiple_of_tile(size):
    """Frames that are not a multiple of the 16x16 tile: the kernel pads
    the depth to whole tiles (padding never passes) and crops; pixels
    equal the XLA path."""
    W, H = size
    clip, uv = _random_tris(np.random.default_rng(W * H), 32)
    out = {}
    for pallas in (False, True):
        plan = passes.RasterPlan(fb_w=W, fb_h=H, tile_w=16, tile_h=16,
                                 entry_cap=2048, cap_per_tile=512,
                                 pallas=pallas)
        out[pallas] = _mesh_pass(plan, clip, uv)
    assert out[True][0].shape == (H, W, 4)
    assert (out[False][1] < 1.0).any()
    np.testing.assert_array_equal(out[True][1], out[False][1])
    np.testing.assert_allclose(out[True][0], out[False][0], atol=1e-6)


def _corner_scene(rng, T, D):
    corner = rng.uniform(-1.5, 1.5, (T, 3, 5)).astype(np.float32)
    corner[..., 2] = rng.uniform(-0.5, 3.0, (T, 3))
    draw = rng.integers(0, D, T).astype(np.int32)
    mvps = np.stack([np.eye(4, dtype=np.float32) + 0.01 * d
                     for d in range(D)])
    mvps[:, 3, 2] = -0.4
    mvps[:, 3, 3] = 2.0
    return corner, draw, mvps


@pytest.mark.parametrize("front_face", [FrontFace.COUNTER_CLOCKWISE,
                                        FrontFace.CLOCKWISE],
                         ids=["ccw", "cw"])
def test_xla_setup_cull_modes(front_face):
    """The XLA vertex stage + setup honours every cull mode: BACK and FRONT
    partition the kept set, FRONT_AND_BACK kills all, and flipping the
    winding convention swaps the two partitions."""
    from tyleri_tpu.ops.clip import near_clip_triangles
    from tyleri_tpu.ops.setup import setup_triangles, transform_corner_table

    rng = np.random.default_rng(9)
    T, D = 400, 3
    corner, draw, mvps = _corner_scene(rng, T, D)
    clip, uv = transform_corner_table(
        jnp.asarray(corner), jnp.asarray(draw), jnp.asarray(mvps))
    ct = near_clip_triangles(clip, uv, jnp.zeros((T,), jnp.int32),
                             jnp.ones((T,), bool), extra_cap=256)
    viewport = jnp.asarray([0, 0, 128, 128, 0, 1], jnp.float32)
    scissor = jnp.asarray([0, 0, 128, 128], jnp.int32)

    def valid(cm, ff=front_face):
        su = setup_triangles(
            ct.clip, ct.uv, ct.tex_id, ct.valid, viewport, scissor,
            tile_w=16, tile_h=16, grid_w=8, grid_h=8, order=ct.order,
            cull_mode=cm, front_face=ff)
        return np.asarray(su.valid)

    none = valid(CullMode.NONE)
    back = valid(CullMode.BACK)
    front = valid(CullMode.FRONT)
    assert none.sum() > 20 and back.any() and front.any()
    np.testing.assert_array_equal(back | front, none)
    assert not (back & front).any()
    assert not valid(CullMode.FRONT_AND_BACK).any()
    other = (FrontFace.CLOCKWISE if front_face == FrontFace.COUNTER_CLOCKWISE
             else FrontFace.COUNTER_CLOCKWISE)
    np.testing.assert_array_equal(valid(CullMode.BACK, other), front)


@pytest.mark.parametrize("n", [2, 3])
def test_draw_mod_mask_on_xla_path(n):
    """The draws-axis round-robin mask (draw id % n == i) on the XLA path:
    the n partial frames each miss draws, and their depth composite is the
    full frame's depth exactly."""
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.rendering.forward import frame_body
    from tyleri_tpu.scene.render_scene import RenderScene
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    res = (128, 96)
    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config4_instances(dev, res, n_instances=9)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(res),
                                     blend_parity="fast")
    scene = RenderScene()
    rig.fill(scene, 0.4)
    arrays = rf.build_frame_inputs(dev, scene.render_resources, 1.0, res)
    assert passes.visibility_backend(rf.plan.raster, rf.mesh_state) == "xla"
    full = np.asarray(jax.jit(lambda *a: frame_body(
        rf.plan, rf.mesh_state, rf.ui_state, *a).depth)(*arrays))
    part = jax.jit(lambda i, *a: frame_body(
        rf.plan, rf.mesh_state, rf.ui_state, *a,
        draw_mod=(jnp.int32(n), i)).depth)
    parts = [np.asarray(part(jnp.int32(i), *arrays)) for i in range(n)]
    covered = full < 1.0
    assert covered.sum() > 50
    for p in parts:
        assert (p < 1.0).sum() < covered.sum()
    np.testing.assert_array_equal(np.minimum.reduce(parts), full)


def test_smoke_compare_visibility_agrees_on_cpu():
    """chip_smoke's kernel-vs-reference check, run through the interpreter
    at a small size: the two resolves agree exactly."""
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.testing.smoke import binned_pass, compare_visibility
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config4_instances(dev, (160, 96), n_instances=12)
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(rig.resolution),
                                     blend_parity="fast")
    arrays, binned = binned_pass(rf, dev, rig)
    r = compare_visibility(rf, arrays, binned)
    assert r["covered"] > 100 and r["entries"] > 0
    assert r["owner_share"] == r["depth_share"] == r["color_share"] == 0.0


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu():
    """The compiled kernel against the XLA reference on the card (the same
    check chip_smoke.py makes at 1080p)."""
    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.testing.smoke import binned_pass, compare_visibility
    from tyleri_tpu.window.swapchain import ImageViewSwapchain

    dev = ty.RenderDeviceBuilder().build()
    rig = scenelib.config4_instances(dev, (480, 272))
    rf = ty.ForwardRenderingFunction(dev, ImageViewSwapchain(rig.resolution),
                                     blend_parity="fast")
    assert passes.visibility_backend(rf.plan.raster, rf.mesh_state) == "kernel"
    arrays, binned = binned_pass(rf, dev, rig)
    r = compare_visibility(rf, arrays, binned)
    assert r["owner_share"] <= 1e-4 and r["color_share"] <= 1e-4
    assert r["max_depth_steps_same_owner"] <= 1.0 + 1e-3
    assert r["max_color_u8_same_owner"] <= 1


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_a_host_without_gpu():
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_to_time_a_non_gpu():
    r = _run([os.path.join(REPO, "bench.py")], REPO)
    assert r.returncode != 0
    assert "fps" not in r.stdout


def test_pipeline_cache_directory_follows_the_environment(monkeypatch,
                                                          tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the one cache directory;
    otherwise the checkout's .jax_cache."""
    from tyleri_tpu.device import pipeline_cache as pc

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert pc.default_directory() == os.path.join(REPO, ".jax_cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        cache = pc.PipelineCache()
        assert cache.enabled and cache.directory == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
