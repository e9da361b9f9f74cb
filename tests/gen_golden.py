"""Regenerate the golden frames from the parity oracle (CPU backend).

Run only when render semantics change intentionally:
  JAX_PLATFORMS=cpu python tests/gen_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from raytracing_cuda_tpu.render.pipeline import render_frame
from raytracing_cuda_tpu.scene.builders import build_scene
from raytracing_cuda_tpu.scene.textures import procedural_skies
from raytracing_cuda_tpu.utils.images import save_png
from raytracing_cuda_tpu.utils.goldens import CASES, GOLDEN_DIR, make_state
from tests.test_golden import H, W, classic_env

if __name__ == "__main__":
    scene = build_scene()
    sky = jnp.asarray(procedural_skies(64, 128))
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, kw in CASES.items():
        img = np.asarray(render_frame(scene, make_state(**kw), sky, H, W,
                                      chunk=4096, path="oracle"))
        save_png(img, os.path.join(GOLDEN_DIR, f"{name}.png"))
        print(name, float(img.mean()))
    cscene, cst = classic_env()
    img = np.asarray(render_frame(cscene, cst, sky, H, W, chunk=4096,
                                  path="oracle"))
    save_png(img, os.path.join(GOLDEN_DIR, "classic_demo.png"))
    print("classic_demo", float(img.mean()))
