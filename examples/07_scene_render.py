"""Debug rendering: orthographic normal-shaded view of a scene.

Mirrors the reference's SceneRender debug renderer (scene.render.glsl):
useful for checking instance transforms, normals and detector placement
before spending compute on a simulation. Writes a PNG-free PPM so it
runs without imaging dependencies.

Run: python examples/07_scene_render.py   (writes /tmp/scene.ppm)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

from theia_jax.material import Material, MaterialStore
from theia_jax.render import SceneRender
from theia_jax.mesh import icosphere, lobed_sphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.testing import WaterTestModel


def main() -> None:
    medium = WaterTestModel().createMedium()
    store = MaterialStore.pack([Material("m", medium, None, flags="DB")])
    meshes = MeshStore(
        {"sphere": icosphere(), "lobed": lobed_sphere()}
    )
    scene = Scene(
        [
            meshes.createInstance("lobed", "m", Transform.TRS(scale=1.0)),
            meshes.createInstance(
                "sphere", "m",
                Transform.TRS(scale=0.4, translate=(1.6, 0.0, 0.6)),
            ),
        ],
        store,
        medium="water_test",
    )
    img = SceneRender(
        width=320,
        height=240,
        dimension=(4.0, 3.0),
        position=(0.0, -5.0, 0.0),
        direction=(0.0, 1.0, 0.0),
        up=(0.0, 0.0, 1.0),
        maxDistance=20.0,
    ).render(scene)
    rgb = np.asarray(img)[..., :3]
    out = Path("/tmp/scene.ppm")
    with out.open("wb") as f:
        f.write(b"P6\n320 240\n255\n")
        f.write(rgb.astype(np.uint8).tobytes())
    hit_frac = (rgb.sum(-1) < 3 * 255).mean()  # background renders white
    print(f"rendered {out} — {hit_frac * 100:.1f}% of pixels hit geometry")


if __name__ == "__main__":
    main()
