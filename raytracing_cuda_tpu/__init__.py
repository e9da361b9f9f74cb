"""raytracing_cuda_tpu — a real-time raytracing engine for NVIDIA GPUs.

A brand-new JAX/XLA/Pallas implementation with the capabilities of the
reference CUDA raytracer (Miki96/raytracing_cuda): a 133-object low-poly
scene rendered with brute-force intersection, Phong shading, hard shadows,
mirror reflections (depth 4), an equirectangular 4-way day/night blended sky,
and an FXAA anti-aliasing post-pass — plus an interactive camera and
time-of-day state machine.

Architecture:
  core/      pytree scene/camera/light types, 3x3 rotation math
  scene/     procedural scene builders (struct-of-arrays), material palettes,
             sky texture loading / procedural generation
  sim/       frame-state pytree + pure jittable step functions (camera,
             controls, sky blend weights, recolor, light orbits)
  ops/       vectorized intersection + shading math shared by all render paths
  render/    pure-jnp reference renderer (parity oracle), the GPU raytracing
             kernel (Pallas through Triton), fused-XLA CPU path, FXAA,
             frame pipeline
  parallel/  multi-device framebuffer and frame sharding over a
             jax.sharding.Mesh
  app/       frame loop (headless + interactive), display, metrics
  utils/     config, image I/O, timing
"""

__version__ = "0.1.0"

from raytracing_cuda_tpu.utils.config import RenderConfig  # noqa: F401
