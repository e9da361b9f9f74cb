"""Engine configuration.

The reference hard-codes every knob as a file-static global (resolution
main.cpp:40-47, camera speeds scene.cpp:14-20, day/night rates
scene.cpp:29-32). Here they live in one dataclass so headless drivers,
benchmarks, and tests can configure runs declaratively.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280           # default framebuffer (main.cpp:42-43)
    height: int = 720
    chunk: int = 32768          # pixels per render batch (memory/pipelining knob)
    path: str = "auto"          # raytracer: 'pallas' | 'fast' | 'oracle' | 'auto'
    # 'auto' → the raytracing kernel on a GPU, the fused-XLA fast path on
    # the CPU (where the kernel runs only in interpret mode)
    scene: str = "island"       # scene family: 'island' | 'classic'
    sky_cache: bool = True      # static all-panorama sky stack (pair blend
                                # at resolve time); False = per-frame
                                # blend+pack one-shot path (debug knob)
    antialiasing: bool = True   # FXAA default on (scene.cpp:24)
    sky_source: str = "auto"    # 'reference' | 'procedural' | 'auto'
    sky_downsample: int = 1     # point-sample every k-th sky texel
    procedural_sky_shape: tuple = (2048, 4096)
    shard_interleave: int = 1   # sharded engines: strided sub-bands per
    # device (device d renders row chunks d, d+n, …) — balances the skewed
    # top-sky/bottom-water row cost across devices; 1 = contiguous bands.
    # Output is bit-identical either way.
    preview: int = 1            # windowed-viewer readback downsample: render
    # full-res on device, box-downsample by this factor on device, read back
    # the small buffer and upscale in the blit. Cuts the per-frame
    # device→host transfer by preview² where the reference presents through
    # zero-copy GL interop (main.cpp:141-165). 1 = off.
    aspect: float | None = None  # None → width/height.
    # NOTE: the reference initializes camera corners with aspect = 1.7777
    # (scene.cpp:20) and only refreshes them on mouse motion, so a run with an
    # untouched camera renders with 1.7777 regardless of resolution. Set
    # aspect=1.7777 to reproduce that quirk for CUDA-frame comparisons.

    _PATHS = ("auto", "pallas", "pallas_interpret", "fast", "oracle")
    _SCENES = ("island", "classic")
    _SKY_SOURCES = ("auto", "reference", "procedural")

    def __post_init__(self):
        # fail at construction with a message, not deep inside a jitted
        # render — the analogue of the reference's checkCudaErrors hygiene
        if self.width < 2 or self.height < 2:
            raise ValueError(f"framebuffer must be at least 2x2, got "
                             f"{self.width}x{self.height}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.path not in self._PATHS:
            raise ValueError(f"path must be one of {self._PATHS}, got "
                             f"{self.path!r}")
        if self.scene not in self._SCENES:
            raise ValueError(f"scene must be one of {self._SCENES}, got "
                             f"{self.scene!r}")
        if self.sky_source not in self._SKY_SOURCES:
            raise ValueError(f"sky_source must be one of {self._SKY_SOURCES},"
                             f" got {self.sky_source!r}")
        if self.sky_downsample < 1:
            raise ValueError(f"sky_downsample must be >= 1, got "
                             f"{self.sky_downsample}")
        if len(self.procedural_sky_shape) != 2 or any(
                v < 8 for v in self.procedural_sky_shape):
            raise ValueError(f"procedural_sky_shape must be (h, w) with both "
                             f">= 8, got {self.procedural_sky_shape!r}")
        if self.aspect is not None and not self.aspect > 0:
            raise ValueError(f"aspect must be positive, got {self.aspect}")
        if self.preview < 1:
            raise ValueError(f"preview must be >= 1, got {self.preview}")
        if self.shard_interleave < 1:
            raise ValueError(f"shard_interleave must be >= 1, got "
                             f"{self.shard_interleave}")
        if self.preview > 1 and (self.width % self.preview
                                 or self.height % self.preview):
            raise ValueError(
                f"preview={self.preview} must divide the framebuffer "
                f"({self.width}x{self.height})")

    def resolved_path(self, backend: str | None = None) -> str:
        if self.path != "auto":
            return self.path
        if backend is None:
            import jax

            backend = jax.default_backend()
        return "pallas" if backend in ("gpu", "cuda") else "fast"


def compilation_cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when set,
    else the fixed <checkout>/.jax_cache (the path is part of the cache key,
    so it must not move between runs)."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes.

    When JAX_COMPILATION_CACHE_DIR is set JAX already reads it, and nothing
    is set here; otherwise the cache goes to compilation_cache_dir().
    """
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
