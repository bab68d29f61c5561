"""Render the BASELINE demo scenes to PNG files — the example/demo surface
the reference never shipped.

    python tools/render_demo.py [outdir] [config...]

Renders a few frames of each requested config (default: 1 2 3 4) through the
full RenderWindow frame loop and writes the last presented frame.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    import tyleri_tpu as ty
    from tyleri_tpu.models import scenes as scenelib
    from tyleri_tpu.utils.image import write_png
    from tyleri_tpu.window.render_window import RenderWindow

    outdir = sys.argv[1] if len(sys.argv) > 1 else "demo_out"
    wanted = sys.argv[2:] or ["1", "2", "3", "4"]
    os.makedirs(outdir, exist_ok=True)

    device = ty.RenderDeviceBuilder().validation_level(ty.ValidationLevel.WARNING).build()
    builders = {
        "1": lambda: scenelib.config1_triangle(device),
        "2": lambda: scenelib.config2_cube(device),
        "3": lambda: scenelib.config3_suzanne(device),
        "4": lambda: scenelib.config4_instances(device),
        "5": lambda: scenelib.config5_sponza(device),
    }
    for key in wanted:
        rig = builders[key]()
        window = RenderWindow(device, resolution=rig.resolution)
        # a UI overlay banner on config 2+ to exercise the overlay path
        (white,) = device.create_textures(
            [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))]
        )
        for f in range(6):
            scene = window.get_render_scene()
            rig.fill(scene, 0.35 + f * 0.1)
            if key != "1":
                w = rig.resolution[0]
                quad = [
                    ((8, 8), (0, 0), (0.1, 0.9, 0.2, 0.8)),
                    ((w // 4, 8), (1, 0), (0.1, 0.9, 0.2, 0.8)),
                    ((w // 4, 28), (1, 1), (0.1, 0.3, 0.9, 0.8)),
                    ((8, 28), (0, 1), (0.1, 0.3, 0.9, 0.8)),
                ]
                scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], white)])
            window.render()
        img = window.flush()
        path = os.path.join(outdir, f"{rig.name}.png")
        write_png(path, img)
        cov = (np.asarray(img)[..., :3].max(-1) > 0).mean()
        print(f"{path}: {img.shape[1]}x{img.shape[0]}, coverage {cov:.1%}, "
              f"{window.profiler.summary()}")


if __name__ == "__main__":
    main()
