"""Kernel/launch configuration constants (analog of ref cuda/kernel_config.h:5-13).

The reference hard-codes CUDA launch geometry (512/256 threads per block,
MAX_BLOCKS=112 for Kepler, WARP_SIZE=32, STACK_SIZE=64 ints per warp). Here
XLA chooses the launch geometry; what remains are leaf sizes and the XLA
engine's traversal-stack depth. The Pallas kernels take their tile shapes
as arguments.
"""

# Default maximum primitives per leaf, matching the value used throughout the
# reference test suite (max_per_leaf = 32, e.g. profile_tree.cu:30).
DEFAULT_MAX_PER_LEAF = 32

# Default per-ray traversal stack depth for the vectorized XLA engine.
VECTOR_STACK_SIZE = 64
