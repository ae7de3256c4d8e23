"""On-device LBVH build: morton -> sort -> Karras -> fit -> collapse -> pack.

The counterpart of tracerboy_tpu/accel/bvh_device.py in plain PyTorch, on
the device of its inputs: one function from triangle vertices to the
packed tables of the traversal kernels (trace/traverse.py), with no host
copy on the way, for the per-frame rebuilds of animated geometry
(Renderer.update_geometry, update_object_geometry). The reference builds
its LBVH on the GPU the same way each time geometry changes
(GpuBVH2Builder.cpp:167-280: scene AABB reduce, morton codes, sort,
Karras splits, bottom-up AABB fit).

The same tree as the JAX function, bit for bit (tests/
test_torch_bvh_device.py):

- 30-bit morton codes (10 bits an axis) in int32. The JAX uint32
  arithmetic runs here in int64 under a 32-bit mask; the values are the
  same.
- The JAX two-key sort on (code, index) is a stable sort on the code
  (the index is ascending already). The common prefix of two keys is
  clz32(code_i ^ code_j) where the codes differ, else 32 + clz32(i ^ j),
  the bit length taken from the exponent of frexp (exact on int32
  values in float64).
- The loops keep the JAX fixed trip counts: 32 + 32 + 32 Karras steps,
  64 fit sweeps, 7 doubling steps. No step reads the device to decide
  whether to stop, so the build makes the same launches for any input
  of a size (about 6,400 on the card: it is bound by their issue).
- A jnp gather clamps an out-of-range index and `.at[].set(mode="drop")`
  drops it; in torch either is a device assert. Every gather clips its
  index as the JAX code does, and each dropping scatter writes into a
  target one row longer whose last row is sliced off.
- The wide table is padded to C = ceil(T / 8) rows; rows [0, num_wide)
  are live and num_wide stays a device scalar (only to_host_widebvh
  reads it on the host).
- Baldwin-Weber rows are computed in float32 on the device (the host
  packer, accel/pack.py, computes them in float64); the kernels' 1e-5
  acceptance band absorbs the difference.
"""

from __future__ import annotations

import numpy as np
import torch

from tracerboy_tpu_torch.accel.bvh import INVALID, WIDE_FACTOR, WideBVH

LEAF = 8            # triangles a cluster (accel/pack.py's LEAF)
BIG = 1e30
_MASK32 = 0xFFFFFFFF
_INVALID = int(INVALID)


# ---------------------------------------------------------------------------
# Morton codes (30-bit, the reference's precision)
# ---------------------------------------------------------------------------

def _expand_bits10(v):
    """Spread the low 10 bits of v (int64) to every third bit."""
    v = v.to(torch.int64) & _MASK32
    v = ((v * 0x00010001) & _MASK32) & 0xFF0000FF
    v = ((v * 0x00000101) & _MASK32) & 0x0F00F00F
    v = ((v * 0x00000011) & _MASK32) & 0xC30C30C3
    v = ((v * 0x00000005) & _MASK32) & 0x49249249
    return v


def morton30(qx, qy, qz):
    """(N,) 10-bit integer coordinates -> 30-bit morton codes (int32)."""
    code = ((_expand_bits10(qx) << 2) | (_expand_bits10(qy) << 1)
            | _expand_bits10(qz))
    return code.to(torch.int32)


# ---------------------------------------------------------------------------
# Karras 2012 radix-tree topology (BuildBVHSplits.hlsli:11-141 semantics)
# ---------------------------------------------------------------------------

def _bit_length32(x):
    """Bit length of each non-negative 32-bit value of x (0 for 0): the
    binary exponent frexp gives, exact for any int32 in float64."""
    return torch.frexp((x.to(torch.int64) & _MASK32).to(torch.float64)
                       ).exponent.to(torch.int32)


def _make_delta(codes, n):
    """delta(i, j): the common-prefix length of the keys (code, index) of
    i and j; -1 where j is out of range."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jj = torch.clamp(j, 0, n - 1)
        ci = codes[torch.clamp(i, 0, n - 1).long()]
        cj = codes[jj.long()]
        code_xor = ci ^ cj
        pfx = torch.where(code_xor != 0, 32 - _bit_length32(code_xor),
                          64 - _bit_length32(i ^ jj))
        return torch.where(valid, pfx, -1)

    return delta


def build_karras_topology_device(codes_sorted):
    """Left and right children ((n-1,) int32 each) of the binary radix
    tree over n sorted keys, ties broken by position. A child >= n-1 is
    leaf child - (n-1)."""
    n = codes_sorted.shape[0]
    assert n >= 2, "topology needs at least two leaves"
    delta = _make_delta(codes_sorted, n)
    i = torch.arange(n - 1, dtype=torch.int32, device=codes_sorted.device)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1)).to(torch.int32)
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential growth of the range; out-of-range probes give -1, so the
    # growth stops below 2n.
    lmax = torch.full((n - 1,), 2, dtype=torch.int32, device=i.device)
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2,
                           lmax)

    # Binary search for the exact range length l.
    l, t = torch.zeros_like(i), lmax // 2
    for _ in range(32):
        probe = delta(i, i + (l + t) * d) > delta_min
        l = torch.where((t > 0) & probe, l + t, l)
        t = t // 2
    j = i + l * d
    delta_node = delta(i, j)

    # Split position search.
    s, t = torch.zeros_like(i), (l + 1) // 2
    for _ in range(32):
        probe = delta(i, i + (s + t) * d) > delta_node
        s = torch.where((t > 0) & probe, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp(d, max=0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, gamma + (n - 1), gamma)
    right = torch.where(hi == gamma + 1, gamma + 1 + (n - 1), gamma + 1)
    return left.to(torch.int32), right.to(torch.int32)


# ---------------------------------------------------------------------------
# Bottom-up AABB fit (ConstructAABBPass analog)
# ---------------------------------------------------------------------------

def fit_aabbs_bottom_up_device(left, right, leaf_lo, leaf_hi):
    """(n_int, 3) node bounds by 64 masked sweeps (64 bounds the depth of
    a radix tree over 30-bit codes tie-broken by index)."""
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]
    dev = left.device

    def child_box(c, node_lo, node_hi, done):
        is_leaf = c >= n_int
        li = torch.clamp(torch.where(is_leaf, c - n_int, 0), 0,
                         n_leaf - 1).long()
        ii = torch.clamp(torch.where(is_leaf, 0, c), 0, n_int - 1).long()
        lo = torch.where(is_leaf[:, None], leaf_lo[li], node_lo[ii])
        hi = torch.where(is_leaf[:, None], leaf_hi[li], node_hi[ii])
        return lo, hi, is_leaf | done[ii]

    node_lo = torch.full((n_int, 3), float("inf"), dtype=torch.float32,
                         device=dev)
    node_hi = torch.full((n_int, 3), float("-inf"), dtype=torch.float32,
                         device=dev)
    done = torch.zeros(n_int, dtype=torch.bool, device=dev)
    for _ in range(64):
        llo, lhi, lready = child_box(left, node_lo, node_hi, done)
        rlo, rhi, rready = child_box(right, node_lo, node_hi, done)
        can = lready & rready & ~done
        node_lo = torch.where(can[:, None], torch.minimum(llo, rlo), node_lo)
        node_hi = torch.where(can[:, None], torch.maximum(lhi, rhi), node_hi)
        done = done | can
    return node_lo, node_hi


# ---------------------------------------------------------------------------
# Depth-3 wide collapse
# ---------------------------------------------------------------------------

def _node_depths(left, right):
    """Depth of every internal node, by parent-pointer doubling."""
    n_int = left.shape[0]
    dev = left.device
    i = torch.arange(n_int, dtype=torch.int32, device=dev)
    # Internal children only: the others land in the extra last row.
    par = torch.full((n_int + 1,), -1, dtype=torch.int32, device=dev)
    par[torch.where(left < n_int, left, n_int).long()] = i
    par[torch.where(right < n_int, right, n_int).long()] = i
    par = par[:n_int]

    depth = (par >= 0).to(torch.int32)
    jump = torch.where(par >= 0, par, i).long()   # the root jumps to itself
    for _ in range(7):   # 2^7 = 128 >= the radix tree's depth bound (64)
        depth = depth + depth[jump]
        jump = jump[jump]
    return depth


def collapse_to_wide_device(left, right, node_lo, node_hi, leaf_lo, leaf_hi,
                            pad_nodes: int):
    """(pad_nodes, 8, 3) bounds and (pad_nodes, 8) children, rows [0, W)
    live, and W as a device scalar. The slots as in accel/bvh.py: a child
    >= 0 is a wide node, -(c+1) leaf cluster c, INVALID an empty slot."""
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]
    dev = left.device
    sent = -1 - n_leaf   # below any encoded cluster

    depth = _node_depths(left, right)
    wide_mask = (depth % 3) == 0
    wid = torch.cumsum(wide_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    left_l, right_l = left.long(), right.long()

    def expand(nodes):
        """(n_int, m) -> (n_int, 2m), one binary level down; a leaf passes
        through in the left slot and the sentinel fills the right."""
        is_inner = (nodes >= 0) & (nodes < n_int)
        idx = torch.clamp(torch.where(is_inner, nodes, 0), 0, n_int - 1)
        lch = torch.where(is_inner, left_l[idx], nodes)
        rch = torch.where(is_inner, right_l[idx], sent)
        return torch.stack([lch, rch], dim=2).reshape(nodes.shape[0], -1)

    roots = torch.arange(n_int, dtype=torch.int64, device=dev)[:, None]
    slots = expand(expand(expand(roots)))            # (n_int, 8)

    is_leaf = slots >= n_int
    is_valid = slots > sent
    leaf_idx = torch.clamp(torch.where(is_leaf, slots - n_int, 0), 0,
                           n_leaf - 1)
    inner_idx = torch.clamp(torch.where(is_valid & ~is_leaf, slots, 0), 0,
                            n_int - 1)
    slot_children = torch.where(
        is_leaf, -(leaf_idx + 1),
        torch.where(is_valid, wid[inner_idx].long(), _INVALID),
    ).to(torch.int32)
    lo = torch.where(is_leaf[..., None], leaf_lo[leaf_idx],
                     torch.where(is_valid[..., None], node_lo[inner_idx],
                                 float("inf")))
    hi = torch.where(is_leaf[..., None], leaf_hi[leaf_idx],
                     torch.where(is_valid[..., None], node_hi[inner_idx],
                                 float("-inf")))

    # Rows of the nodes that are not wide land in the extra last row.
    rows = torch.where(wide_mask, wid, pad_nodes).long()
    b_lo = torch.full((pad_nodes + 1, WIDE_FACTOR, 3), float("inf"),
                      dtype=torch.float32, device=dev)
    b_hi = torch.full((pad_nodes + 1, WIDE_FACTOR, 3), float("-inf"),
                      dtype=torch.float32, device=dev)
    children = torch.full((pad_nodes + 1, WIDE_FACTOR), _INVALID,
                          dtype=torch.int32, device=dev)
    b_lo[rows] = lo
    b_hi[rows] = hi
    children[rows] = slot_children
    num_wide = wide_mask.sum(dtype=torch.int32)
    return b_lo[:pad_nodes], b_hi[:pad_nodes], children[:pad_nodes], num_wide


# ---------------------------------------------------------------------------
# Full build
# ---------------------------------------------------------------------------

def build_bvh_device(v0, v1, v2, leaf_size: int = LEAF) -> dict:
    """An 8-wide LBVH over (T, 3) float32 triangle vertices, on their
    device. Returns dict(bounds_lo, bounds_hi (C, 8, 3), children (C, 8)
    int32 (rows [0, num_wide) live), tri_order (C * leaf_size,) int32,
    num_wide (a 0-d int32 tensor), world_lo, world_hi (3,))."""
    v0, v1, v2 = (torch.as_tensor(v, dtype=torch.float32) for v in (v0, v1,
                                                                      v2))
    dev = v0.device
    T = v0.shape[0]
    C = (T + leaf_size - 1) // leaf_size

    centroid = (v0 + v1 + v2) * (1.0 / 3.0)
    scene_lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0)
    scene_hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0)
    extent = torch.clamp(scene_hi - scene_lo, min=1e-12)
    q = torch.clamp((centroid - scene_lo) / extent * 1023.0, 0.0,
                    1023.0).to(torch.int64)
    codes = morton30(q[:, 0], q[:, 1], q[:, 2])

    order = torch.sort(codes, stable=True).indices.to(torch.int32)
    pad = C * leaf_size - T
    if pad:
        order = torch.cat([order, order[-1:].expand(pad)])
    cl = order.long().reshape(C, leaf_size)

    w0, w1, w2 = v0[cl], v1[cl], v2[cl]
    leaf_lo = torch.minimum(torch.minimum(w0, w1), w2).amin(1)
    leaf_hi = torch.maximum(torch.maximum(w0, w1), w2).amax(1)
    # A cluster's key is its first triangle's code; cl holds original
    # triangle ids, so this indexes the unsorted codes.
    cl_codes = codes[cl[:, 0]]

    if C == 1:
        b_lo = torch.full((1, WIDE_FACTOR, 3), float("inf"),
                          dtype=torch.float32, device=dev)
        b_hi = torch.full((1, WIDE_FACTOR, 3), float("-inf"),
                          dtype=torch.float32, device=dev)
        b_lo[0, 0] = leaf_lo[0]
        b_hi[0, 0] = leaf_hi[0]
        children = torch.full((1, WIDE_FACTOR), _INVALID, dtype=torch.int32,
                              device=dev)
        children[0, 0] = -1
        num_wide = torch.ones((), dtype=torch.int32, device=dev)
    else:
        left, right = build_karras_topology_device(cl_codes)
        node_lo, node_hi = fit_aabbs_bottom_up_device(left, right, leaf_lo,
                                                      leaf_hi)
        b_lo, b_hi, children, num_wide = collapse_to_wide_device(
            left, right, node_lo, node_hi, leaf_lo, leaf_hi, pad_nodes=C)

    return dict(bounds_lo=b_lo, bounds_hi=b_hi, children=children,
                tri_order=order, num_wide=num_wide, world_lo=scene_lo,
                world_hi=scene_hi)


def _cross(a, b):
    """a x b, term by term as jnp.cross writes it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def bw_rows_device(v0, v1, v2):
    """Baldwin-Weber rows (T, 3, 4) in float32 on the device: accel/pack.py's
    bw_rows, whose float64 precompute the host packer keeps."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = _cross(e1, e2)
    nn = (n * n).sum(1)
    good = nn > 1e-24
    inv = torch.where(good, 1.0 / torch.clamp(nn, min=1e-24), 0.0)[:, None]
    g1 = _cross(e2, n) * inv
    g2 = _cross(n, e1) * inv
    dd = (n * v0).sum(1)
    h1 = -(g1 * v0).sum(1)
    h2 = -(g2 * v0).sum(1)
    n = torch.where(good[:, None], n, 0.0)
    dd = torch.where(good, dd, 0.0)
    return torch.stack([torch.cat([n, -dd[:, None]], 1),
                        torch.cat([g1, h1[:, None]], 1),
                        torch.cat([g2, h2[:, None]], 1)], dim=1)


def pack_for_pallas_device(built, v0, v1, v2) -> dict:
    """The traversal kernels' tables from a device build (accel/pack.py's
    pack_bvh on the device): nodes (C, 128) int32, tris_bw (C, 128)
    float32, tri_map (C * 8,) int32. The node table keeps the build's C
    rows; rows from num_wide on are never reached from the root."""
    lo, hi = built["bounds_lo"], built["bounds_hi"]
    ch = built["children"]
    valid = (ch != _INVALID)[..., None]
    lo = torch.where(valid, lo, BIG)
    hi = torch.where(valid, hi, -BIG)
    W = lo.shape[0]
    bounds = torch.cat([lo, hi], dim=2)                  # (W, 8, 6)
    nodes = torch.zeros((W, 128), dtype=torch.int32, device=lo.device)
    nodes[:, :48] = bounds.transpose(1, 2).reshape(W, 48).view(torch.int32)
    nodes[:, 48:56] = ch

    order = built["tri_order"]
    idx = order.long()
    w0, w1, w2 = (torch.as_tensor(v, dtype=torch.float32)[idx]
                  for v in (v0, v1, v2))
    C = order.shape[0] // LEAF
    tris_bw = torch.zeros((C, 128), dtype=torch.float32, device=lo.device)
    tris_bw[:, :LEAF * 12] = bw_rows_device(w0, w1, w2).reshape(C, LEAF * 12)
    return dict(nodes=nodes, tris_bw=tris_bw, tri_map=order)


def to_host_widebvh(built, num_tris: int, leaf_size: int = LEAF) -> WideBVH:
    """A device build as the host WideBVH (rows cut to num_wide), for
    validate_bvh and the host packer."""
    W = int(built["num_wide"])

    def host(key):
        return built[key].cpu().numpy()

    return WideBVH(
        bounds_lo=host("bounds_lo")[:W], bounds_hi=host("bounds_hi")[:W],
        children=host("children")[:W],
        tri_order=host("tri_order").astype(np.int64), leaf_size=leaf_size,
        num_tris=num_tris, world_lo=host("world_lo"),
        world_hi=host("world_hi"),
        num_clusters=built["tri_order"].shape[0] // leaf_size)
