"""grace_jax — an SPH/BVH ray-tracing framework in JAX.

A JAX/XLA/Pallas design with the capabilities of the GRACE
CUDA library (Morton keys, LBVH construction, generic BVH traversal, SPH
cubic-spline line integration, ray generation, segmented post-processing),
extended with differentiable rendering and multi-chip sharding.

See COMPONENTS.md for the reference-component -> module map.
"""

from grace_jax.core.types import Octants, Rays, RaySortType, make_spheres
from grace_jax.core.tree import Tree
from grace_jax.build.sph import (
    albvh_sph,
    build_primitive_tree,
    build_sph_tree,
    euclidean_deltas_sph,
    morton_keys_sph,
    sort_by_morton,
    surface_area_deltas_sph,
    xor_deltas_sph,
)
from grace_jax.trace.sph import (
    SphTraceResult,
    trace_cumulative_sph,
    trace_hitcounts_sph,
    trace_sph,
    trace_with_sentinels_sph,
)

from grace_jax.rays import gen as ray_gen
from grace_jax.rays import statistics as ray_statistics
from grace_jax.rays import hypothesis as ray_hypothesis
from grace_jax.trace.pallas_kernel import pallas_trace_sph
from grace_jax.trace.render import render_column_density
from grace_jax.trace.splat import (
    OrthoCamera,
    render_ortho_splat,
    splat_reference_jnp,
)
from grace_jax.io.checkpoint import load_scene, save_scene

__version__ = "0.1.0"
