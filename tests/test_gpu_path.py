"""The GPU path around the raytracing kernel: launch padding, the choice of
render path, the compile cache's placement, and chip_smoke.py's contract.

The kernel itself runs here in interpret mode (test_render_fast.py,
test_golden.py); its compiled form needs the card (`gpu` marker).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_cuda_tpu.render.pallas_rt import (BLOCK,
                                                  render_base_planes_pallas)
from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                ISLAND_TRI_CLUSTERS,
                                                ISLAND_TRI_SUBS)
from raytracing_cuda_tpu.sim import state as sim
from raytracing_cuda_tpu.utils.config import RenderConfig

REPO = pathlib.Path(__file__).parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planes_fn(scene, height, width, **kw):
    st = sim.settle(sim.init_state())

    def fn(scene):
        scene_f, lights, ambient = sim.derive_frame(scene, st)
        return render_base_planes_pallas(
            scene_f, lights, ambient, sim.camera_rays(st.cam, width / height),
            height, width, tri_clusters=ISLAND_TRI_CLUSTERS,
            sph_clusters=ISLAND_SPH_CLUSTERS, t_subs=ISLAND_TRI_SUBS, **kw)
    return fn


def _pallas_calls(jaxpr):
    for e in jaxpr.eqns:
        if e.primitive.name == "pallas_call":
            yield e
            continue
        for v in e.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                yield from _pallas_calls(sub)


@pytest.mark.parametrize("height,width", [(720, 1280), (1080, 1920),
                                          (479, 641)])
def test_kernel_block_padding(scene, height, width):
    """The launch covers the frame with whole blocks (padded up to the
    block) and the planes come back cropped to the frame."""
    TH, TW, _ = BLOCK
    jaxpr = jax.make_jaxpr(_planes_fn(scene, height, width,
                                      interpret=True))(scene)
    inner = list(_pallas_calls(jaxpr.jaxpr))
    assert len(inner) == 1
    h_pad, w_pad = -(-height // TH) * TH, -(-width // TW) * TW
    assert inner[0].params["grid_mapping"].grid == (h_pad // TH, w_pad // TW)
    assert all(v.aval.shape == (h_pad, w_pad) for v in inner[0].outvars)
    outs = jax.eval_shape(_planes_fn(scene, height, width, interpret=True),
                          scene)
    assert [o.shape for o in outs] == [(height, width)] * 7


def test_kernel_rejects_unaligned_launch(scene):
    from raytracing_cuda_tpu.render.pallas_rt import (N_PARAMS, cluster_table,
                                                      pack_scene,
                                                      raytrace_planes)

    table, n_tri = cluster_table(scene)
    with pytest.raises(ValueError, match="multiple"):
        raytrace_planes(pack_scene(scene), table, jnp.zeros(N_PARAMS),
                        height=20,
                        width=32, total_h=20, total_w=32, n_tri_cl=n_tri,
                        block=(16, 16, 4), interpret=True)


@pytest.mark.parametrize("backend,path", [("gpu", "pallas"),
                                          ("cuda", "pallas"),
                                          ("cpu", "fast")])
def test_resolved_path_auto(backend, path):
    assert RenderConfig().resolved_path(backend) == path


@pytest.mark.parametrize("path", ["pallas", "pallas_interpret", "fast",
                                  "oracle"])
def test_resolved_path_explicit(path):
    assert RenderConfig(path=path).resolved_path("gpu") == path
    assert RenderConfig(path=path).resolved_path("cpu") == path


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and nothing
    is set in code; without it, at the fixed <checkout>/.jax_cache."""
    from raytracing_cuda_tpu.utils import config

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() == str(tmp_path)
    config.enable_compilation_cache()
    assert calls == []

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    fixed = str(REPO.resolve() / ".jax_cache")
    assert config.compilation_cache_dir() == fixed
    config.enable_compilation_cache()
    assert calls == [("jax_compilation_cache_dir", fixed)]


def test_compile_cache_env_reaches_jax(tmp_path):
    """JAX itself reads JAX_COMPILATION_CACHE_DIR, in a fresh process."""
    import os
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; from raytracing_cuda_tpu.utils.config import "
         "enable_compilation_cache as e; e(); "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, check=True, cwd=REPO,
        env=dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
                 JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == str(tmp_path)


def test_chip_smoke_refuses_cpu(capsys):
    smoke = _load("chip_smoke")
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main_args([])
    assert '"ok"' not in capsys.readouterr().out


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("argv,count", [([], 1), (["--four"], 4)])
def test_chip_smoke_last_line(monkeypatch, capsys, argv, count):
    """The last stdout line is exactly the driver's JSON object, with the
    device as JAX reports it; with --four only the four-card phase runs."""
    smoke = _load("chip_smoke")
    ran = []
    for phase in ("loop", "parity", "kernel", "record", "four"):
        monkeypatch.setattr(smoke, f"phase_{phase}",
                            lambda p=phase: ran.append(p))
    monkeypatch.setattr(smoke.bench, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(smoke.jax, "devices", lambda: [_FakeGpu()] * count)
    smoke.main_args(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[:-1]
    assert ran == (["four"] if count == 4
                   else ["loop", "parity", "kernel", "record"])


@pytest.mark.gpu
def test_compiled_kernel_matches_interpret(scene):
    """The Triton-compiled kernel against its own interpret mode on a small
    frame (needs the card)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled kernel has no CPU form")
    scene = jax.device_put(scene)
    got = jax.jit(_planes_fn(scene, 48, 80))(scene)
    want = jax.jit(_planes_fn(scene, 48, 80, interpret=True))(scene)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
