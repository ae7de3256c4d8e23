"""Structure-of-arrays 3-vectors: tuples of (N,) component tensors.

The wavefront keeps every vector as three dense planes (the layout of
tracerboy_tpu/core/vec3.py), so each stage can be held against its JAX
counterpart plane by plane and the traversal kernels get their (N, 3)
rows from one stack. All functions broadcast over scalars and (N,)
tensors alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def from_rows(a: torch.Tensor) -> V3:
    """(N, 3) -> V3 of (N,) tensors."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: V3) -> torch.Tensor:
    """V3 -> contiguous (N, 3)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def splat(c) -> V3:
    """A constant 3-vector (a sequence) as float32 scalar components."""
    return V3(*(torch.tensor(c[i], dtype=torch.float32) for i in range(3)))


def full_like(ref: V3, value: float) -> V3:
    return V3(torch.full_like(ref.x, value), torch.full_like(ref.y, value),
              torch.full_like(ref.z, value))


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: V3) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v), 1e-20))


def normalize(v: V3) -> V3:
    inv = torch.rsqrt(torch.clamp_min(dot(v, v), 1e-20))
    return V3(v.x * inv, v.y * inv, v.z * inv)


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(v: V3, n: V3) -> V3:
    d = 2.0 * dot(v, n)
    return V3(v.x - d * n.x, v.y - d * n.y, v.z - d * n.z)


def min_c(v: V3) -> torch.Tensor:
    return torch.minimum(torch.minimum(v.x, v.y), v.z)


def max_c(v: V3) -> torch.Tensor:
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


def mean_c(v: V3) -> torch.Tensor:
    return (v.x + v.y + v.z) / 3.0


def any_gt(v: V3, t) -> torch.Tensor:
    return (v.x > t) | (v.y > t) | (v.z > t)


def all_lt(v: V3, t) -> torch.Tensor:
    return (v.x < t) & (v.y < t) & (v.z < t)


def luminance(v: V3) -> torch.Tensor:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def exp(v: V3) -> V3:
    return V3(torch.exp(v.x), torch.exp(v.y), torch.exp(v.z))


def isnan_any(v: V3) -> torch.Tensor:
    return torch.isnan(v.x) | torch.isnan(v.y) | torch.isnan(v.z)


def orthonormal_basis(n: V3):
    """Tangent/bitangent frame (the reference's
    ReorientVectorAroundNormal branch structure, branch-free)."""
    use_x = torch.abs(n.x) > torch.abs(n.y)
    inv_xz = torch.rsqrt(torch.clamp_min(n.x * n.x + n.z * n.z, 1e-20))
    inv_yz = torch.rsqrt(torch.clamp_min(n.y * n.y + n.z * n.z, 1e-20))
    zero = torch.zeros_like(n.x)
    t = V3(
        torch.where(use_x, -n.z * inv_xz, zero),
        torch.where(use_x, zero, n.z * inv_yz),
        torch.where(use_x, n.x * inv_xz, -n.y * inv_yz),
    )
    return t, cross(n, t)


def reorient(v: V3, n: V3) -> V3:
    """Map local (x, y=up, z) into the frame around n."""
    t, b = orthonormal_basis(n)
    return normalize(
        V3(
            v.x * t.x + v.y * n.x + v.z * b.x,
            v.x * t.y + v.y * n.y + v.z * b.y,
            v.x * t.z + v.y * n.z + v.z * b.z,
        )
    )
