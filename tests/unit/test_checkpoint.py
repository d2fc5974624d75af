"""Checkpoint round-trip: a restored scene must trace identically."""

import numpy as np
import jax
import jax.numpy as jnp

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from grace_jax.io.checkpoint import load_scene, save_scene
from grace_jax.rays.gen import uniform_random_rays
from grace_jax.trace.sph import trace_hitcounts_sph
from grace_jax.utils.timers import Timer


def test_checkpoint_roundtrip(tmp_path, rng):
    spheres = make_spheres(rng.random((2000, 3)).astype(np.float32),
                           (0.02 + 0.03 * rng.random(2000)).astype(np.float32))
    ss, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 16)
    w = jnp.asarray(rng.random(2000).astype(np.float32))
    path = str(tmp_path / "scene.npz")
    save_scene(path, ss, tree, weights=w)

    ss2, tree2, w2 = load_scene(path)
    np.testing.assert_array_equal(np.array(ss), np.array(ss2))
    np.testing.assert_array_equal(np.array(w), np.array(w2))
    assert tree2.max_per_leaf == tree.max_per_leaf

    rays = uniform_random_rays(jax.random.key(0), 128, (0.5, 0.5, 0.5), 2.0)
    c1 = np.array(trace_hitcounts_sph(rays, ss, tree))
    c2 = np.array(trace_hitcounts_sph(rays, ss2, tree2))
    assert np.array_equal(c1, c2)


def test_timer_splits():
    t = Timer().start()
    x = jnp.ones((64, 64)).sum()
    dt1 = t.split(sync_on=x)
    assert dt1 >= 0
    assert t.elapsed() >= dt1
