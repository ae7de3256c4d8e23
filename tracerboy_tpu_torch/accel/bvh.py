"""The 8-wide BVH record shared by the builder and the packer.

Child encoding (the same as tracerboy_tpu/accel/bvh.py):
  child >= 0           : index of another wide node
  child == INVALID     : empty slot
  child <  0 (not INV) : leaf cluster -child-1, i.e. triangles
                         [cluster*leaf_size, (cluster+1)*leaf_size)
                         of tri_order.

The port builds its trees with the native SAH builder only
(accel/native.py); the JAX package's numpy LBVH builder is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INVALID = np.int32(2**31 - 1)


@dataclass
class WideBVH:
    """8-wide SoA BVH over triangle clusters."""

    bounds_lo: np.ndarray      # (W, 8, 3) child AABB min
    bounds_hi: np.ndarray      # (W, 8, 3) child AABB max
    children: np.ndarray       # (W, 8) int32, see encoding above
    tri_order: np.ndarray      # (C*K,) map: new index -> original tri id
    leaf_size: int
    num_tris: int              # real (unpadded) triangle count
    world_lo: np.ndarray       # (3,) scene bounds
    world_hi: np.ndarray
    num_clusters: int = 0      # leaf clusters (tri_order length / leaf_size)

    @property
    def num_nodes(self) -> int:
        return self.children.shape[0]
