"""Generate full-resolution parity goldens for the compiled-path gates.

Renders golden states through the ORACLE path on the CPU backend and stores
them as PNGs under tests/golden/full/ (canonical 1280x720) or
tests/golden/full/{W}x{H}/ (other sizes). Two golden families:

  * the four procedural-sky states (CASES, deterministic 2048x4096
    procedural sky — standalone, no reference assets needed);
  * two reference-sky states (CASES_REF, the real 8192x4096 panoramas from
    assets/backgrounds — one of them mid-crossfade, day = 9.0, so the
    two-panorama truncated blend itself is gated end to end).

bench.py and chip_smoke.py render the same states through the engine's
compiled GPU path and gate them against these frames
(utils.images.parity); bench.py shells out to this script
(JAX_PLATFORMS=cpu) for a size with no goldens on disk.

Run directly only when render semantics change intentionally:
  JAX_PLATFORMS=cpu python tests/gen_full_golden.py [--size WxH]
      [--sky procedural|reference|both]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from raytracing_cuda_tpu.utils.goldens import (CASES, CASES_REF,
                                               FULL_SIZE, FULL_SKY_SHAPE,
                                               full_golden_dir, make_state)

W, H = FULL_SIZE


def generate(w: int, h: int, sky_kind: str, only_missing: bool = True):
    """Render oracle goldens at (w, h) for the given sky family."""
    import jax.numpy as jnp

    from raytracing_cuda_tpu.render.pipeline import render_frame
    from raytracing_cuda_tpu.scene.builders import build_scene
    from raytracing_cuda_tpu.scene.textures import (REFERENCE_BACKGROUNDS,
                                                    load_reference_skies,
                                                    procedural_skies)
    from raytracing_cuda_tpu.utils.images import save_png

    scene = build_scene()
    out_dir = full_golden_dir(w, h)
    os.makedirs(out_dir, exist_ok=True)
    if sky_kind == "procedural":
        sky, cases = jnp.asarray(procedural_skies(*FULL_SKY_SHAPE)), CASES
    else:
        if not os.path.exists(REFERENCE_BACKGROUNDS):
            print("reference backgrounds absent; skipping ref goldens",
                  flush=True)
            return
        sky, cases = jnp.asarray(load_reference_skies()), CASES_REF
    for name, kw in cases.items():
        path = os.path.join(out_dir, f"{name}.png")
        if only_missing and os.path.exists(path):
            continue
        img = np.asarray(render_frame(scene, make_state(**kw), sky, h, w,
                                      chunk=32768, path="oracle"))
        save_png(img, path)
        print(f"{name} ({w}x{h}, {sky_kind}): mean={float(img.mean()):.2f}",
              flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default=f"{W}x{H}")
    ap.add_argument("--sky", default="both",
                    choices=["procedural", "reference", "both"])
    ap.add_argument("--force", action="store_true",
                    help="regenerate even if the PNGs exist")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.lower().split("x"))
    kinds = (["procedural", "reference"] if args.sky == "both"
             else [args.sky])
    for kind in kinds:
        generate(w, h, kind, only_missing=not args.force)
