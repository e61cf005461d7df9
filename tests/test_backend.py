"""The platform choices (lif_tpu.backend), the flax-free pytrees, the
seeded flagship scene, and chip_smoke.py's refusal to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lif_tpu import Camera, backend, projector_from_arrays
from lif_tpu.io import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,impl", [("gpu", "triton"), ("cpu", "xla"), ("METAL", "xla")]
)
def test_march_impl_per_platform(platform, impl):
    assert backend.march_impl(platform) == impl


def test_march_impl_default_is_the_default_backend():
    assert backend.march_impl() == "xla"  # the tests run on the CPU


@pytest.mark.parametrize(
    "platform,steps,unroll",
    [("gpu", 40, True), ("gpu", 16, True), ("gpu", 640, False),
     ("cpu", 40, False)],
)
def test_raycast_unroll_per_platform(platform, steps, unroll):
    assert backend.raycast_unroll(steps, platform) is unroll


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert backend.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = backend.configure_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def _camera():
    return Camera.create(16, 8, focal_px=12.0, position=[0.1, 0.0, 0.0])


def _projector():
    rng = np.random.default_rng(0)
    return projector_from_arrays(
        rng.random((8, 16, 3)), rng.random((8, 16)), focal_px=12.0,
        invz_min=2.0, invz_max=0.1,
    )


@pytest.mark.parametrize("make", [_camera, _projector])
def test_pytree_roundtrip_keeps_static_fields(make):
    obj = make()
    leaves, tree = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert type(back) is type(obj)
    assert back.width == obj.width and back.height == obj.height
    # static fields live in the treedef, never among the leaves
    assert all(not isinstance(x, int) for x in leaves)
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pytree_static_fields_are_jit_static():
    cam = _camera()

    @jax.jit
    def area_scaled(c):
        # width/height must be Python ints here (shapes need statics)
        return jnp.zeros((c.height, c.width)) + c.position[0]

    out = area_scaled(cam)
    assert out.shape == (8, 16)
    assert float(out[0, 0]) == pytest.approx(0.1)


def test_pytree_replace_and_frozen():
    proj = _projector()
    moved = proj.replace(position=np.asarray([1.0, 2.0, 3.0], np.float32))
    assert np.array_equal(moved.position, [1.0, 2.0, 3.0])
    assert moved.width == proj.width and moved.rgb is proj.rgb
    with pytest.raises(Exception):
        proj.width = 3


def test_flagship_scene_constants():
    s = synthetic.flagship_scene(seed=0)
    assert s.rgb.shape == (800, 1280, 3) and s.disp.shape == (800, 1280)
    assert s.rgb.dtype == np.float32 and s.disp.dtype == np.float32
    assert s.focal_px == pytest.approx(0.78 * 1280)
    assert (s.invz_min, s.invz_max, s.baseline) == (0.09, 0.0001, 0.045)
    assert 0.0 < s.disp.min() < 0.01 and 0.85 < s.disp.max() <= 1.0
    assert 0.0 <= s.rgb.min() and s.rgb.max() <= 1.0


def test_flagship_scene_is_seeded():
    a = synthetic.flagship_scene(seed=3, scale=4)
    b = synthetic.flagship_scene(seed=3, scale=4)
    c = synthetic.flagship_scene(seed=4, scale=4)
    assert np.array_equal(a.rgb, b.rgb) and np.array_equal(a.disp, b.disp)
    assert not np.array_equal(a.rgb, c.rgb)


def test_flagship_projector_and_orbit_center():
    proj = synthetic.flagship_projector(seed=0, scale=4)
    assert (proj.width, proj.height) == (320, 200)
    assert float(proj.focal[0]) == pytest.approx(0.78 * 320)
    center = synthetic.flagship_orbit_center(proj)
    # convergence at baseline / invd = 1 m down the principal ray
    assert np.allclose(center, [0.0, 0.0, -1.0], atol=1e-6)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_gpu_kernel_matches_twin_on_card(gpu):
    """The compiled lateral kernel against its XLA twin on the card."""
    from lif_tpu.ops import sweep_march
    from lif_tpu.ops.sweep_march_gpu import render_translation_batch_gpu

    proj = synthetic.flagship_projector(seed=0, scale=2)
    f1 = float(proj.focal[0])
    cxs = [0.1, 0.155]
    tabs, k = sweep_march.snap_plane_tables_batch(f1, cxs, 2.0, 0.0022)
    plan = sweep_march.translation_plan(640, 400, 640, 400,
                                        f1 * 0.155 * 2.0, 0.0)
    args = (jnp.asarray(proj.rgb[0]), jnp.asarray(proj.disp[0]),
            jnp.asarray(proj.mask[0]), 2.0, 0.0022)
    c1 = jnp.asarray([[c, 0.0, 0.0] for c in cxs], jnp.float32)
    got = np.asarray(render_translation_batch_gpu(
        *args, c1, f1, jnp.asarray(tabs), jnp.zeros(4), plan, k))
    for i in range(len(cxs)):
        want = np.asarray(sweep_march.render_translation_xla(
            *args, c1[i], f1, jnp.asarray(tabs[i]), jnp.zeros(4), plan, k))
        assert (np.abs(got[i] - want).max(-1) > 1e-3).mean() <= 1e-3
