"""Differentiable column-density training demo: fit particles to a target
image.

The capability the CUDA reference does not have: its flagship workload
(column-density projection, ref tests/project_gadget/project_gadget.cu)
made differentiable end to end. A randomly initialized particle cloud is
optimized (positions, smoothing lengths, weights) to reproduce a target
column-density image rendered from a hidden scene, through
``render_column_density`` (grace_jax.trace.render: BVH hit records, then
an autodiff-friendly gather + kernel evaluation + segment sum). The tree is
rebuilt from the current particles every step.

Usage:
    python examples/train_splat.py [steps] [--small]

--small runs a 500-particle, 32x32 scene (a quick check on any backend).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv):
    import jax
    import jax.numpy as jnp
    import optax
    from grace_jax.build.sph import build_sph_tree
    from grace_jax.rays.gen import orthographic_projection_rays
    from grace_jax.trace.render import render_column_density

    small = "--small" in argv
    argv = [a for a in argv if not a.startswith("--")]
    steps = int(argv[0]) if argv else 60

    n = 500 if small else 65_536
    side = 32 if small else 256
    capacity = 1 << (16 if small else 24)
    rays = orthographic_projection_rays(side, side, (0.5, 0.5, -2.0),
                                        (0.5, 0.5, 0.5), (0.0, 1.0, 0.0),
                                        1.2, 6.0)

    def cloud(seed):
        r = np.random.default_rng(seed)
        pos = (0.25 + 0.5 * r.random((n, 3))).astype(np.float32)
        h = (0.02 + 0.04 * r.random(n)).astype(np.float32)
        return jnp.asarray(np.concatenate([pos, h[:, None]], axis=1))

    def render(spheres, weights):
        s, tree, perm = build_sph_tree(spheres, 32)
        return render_column_density(rays, s, tree, capacity,
                                     weights=weights[perm])

    target = jax.jit(render)(cloud(7), jnp.ones((n,), jnp.float32))
    opt = optax.adam(3e-3)
    params = (cloud(1), jnp.ones((n,), jnp.float32))
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(params):
            return jnp.mean((render(*params) - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    loss0 = None
    for i in range(steps):
        params, state, loss = step(params, state)
        if loss0 is None:
            loss0 = float(loss)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6e}")
    print(f"loss reduced {loss0 / float(loss):.1f}x over {steps} steps")
    assert float(loss) < loss0, "optimization must reduce the loss"


if __name__ == "__main__":
    main(sys.argv[1:])
