"""Minimal OpenVDB (.vdb) FloatGrid reader/writer for fog volumes.

A copy of tracerboy_tpu/scene/vdb.py (numpy, struct and zlib only; the
port imports nothing of the JAX package). It closes the reference's
openvdb capability (TracerBoy.cpp:1096-1184: load one density grid into
a 3D texture + world bounds; vendored openvdb, compile-disabled via
USE_OPENVDB 0): a `.vdb` density grid decodes into VolumeIR (dense grid
+ bounds), which the wavefront's delta-tracking medium renders.

This is a from-scratch implementation of the OpenVDB file format
(version 220-224 archives), written against the serialization behavior
of the openvdb sources vendored in the reference (all `file:line` cites
below are into its openvdb/ directory). Scope — exactly what a fog
volume needs:

- FloatTree_5_4_3 grids (the standard Root -> Internal32 -> Internal16
  -> Leaf8 topology), float or half precision;
- uncompressed or ZIP-compressed value streams (io/Compression.cc:
  zipToStream — int64 byte count, negative = stored raw); BLOSC is
  rejected with a clear error;
- active-mask value compression with all seven metadata codes
  (io/Compression.h:69-76);
- root-level and internal-node active tiles (constant-value regions);
- linear (scale + translate) transforms (math/Maps.h map types).

Format facts (verified against the vendored reader):
- Header (io/Archive.cc readHeader/writeHeader): int64 magic 0x56444220,
  uint32 file version, uint32 library major/minor (>=211), 1-byte
  has-grid-offsets flag (>=212), 1-byte is-compressed flag (only
  220 <= v < 222), 36-char ASCII uuid (>=218).
- Strings are uint32 length + bytes (util/Name.h:30-36); a MetaMap is
  uint32 count of (name, typeName, uint32 size, value bytes) records
  (MetaMap.cc writeMeta).
- Per grid (io/Archive.cc writeGrid): descriptor (unique name, grid
  type [+ "_HalfFloat" suffix], instance parent), 3x int64 stream
  offsets, uint32 per-grid compression flags (>=222), grid MetaMap,
  transform (map type name + map doubles), tree topology, tree buffers.
- Tree topology (tree/Tree.h:1272, RootNode.h:2254, InternalNode.h:2185,
  LeafNode.h:1292): int32 buffer count (1); root background value,
  uint32 tile/child counts, tiles as (int32 xyz, value, bool active),
  children as (int32 xyz origin, node); internal nodes store child mask,
  value mask (uint64 words, LSB-first; util/NodeMasks.h:566-570), then
  their tile values mask-compressed; leaves store just the value mask.
- Tree buffers (LeafNode.h:1412): per leaf (depth-first, ascending
  offset), value mask again, then the 512 voxel values mask-compressed.
- Voxel/slot offsets are x-major: leaf offset = x<<6 | y<<3 | z
  (LeafNode.h coordToOffset); internal offset likewise on coarse
  coordinates (InternalNode.h coordToOffset).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x56444220                # version.h:166
FILE_VERSION = 224                # version.h:181 (vendored library)
LIB_MAJOR, LIB_MINOR = 7, 1

COMPRESS_NONE = 0
COMPRESS_ZIP = 0x1
COMPRESS_ACTIVE_MASK = 0x2
COMPRESS_BLOSC = 0x4

# Mask-compression metadata codes (io/Compression.h:69-76)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

LEAF_LOG2 = 3                     # 8^3 leaves
INT1_LOG2 = 4                     # 16^3 internal (of leaves)
INT2_LOG2 = 5                     # 32^3 internal (of internal16)
LEAF_DIM = 1 << LEAF_LOG2
LEAF_SIZE = LEAF_DIM ** 3                      # 512
INT1_SIZE = (1 << INT1_LOG2) ** 3              # 4096
INT2_SIZE = (1 << INT2_LOG2) ** 3              # 32768
INT1_TOTAL = LEAF_LOG2 + INT1_LOG2             # log2 voxel span 128
INT2_TOTAL = INT1_TOTAL + INT2_LOG2            # log2 voxel span 4096


# ---------------------------------------------------------------------------
# Primitives


def _rd(f, fmt):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError("truncated .vdb stream")
    out = struct.unpack("<" + fmt, data)
    return out if len(out) > 1 else out[0]


def _rd_string(f) -> str:
    n = _rd(f, "I")
    return f.read(n).decode("utf-8", "replace")


def _wr_string(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<I", len(b)))
    f.write(b)


def _rd_mask(f, nbits: int) -> np.ndarray:
    """uint64-word bitmask -> (nbits,) bool, LSB-first per word."""
    nbytes = max(nbits // 8, 8)
    raw = np.frombuffer(f.read(nbytes), np.uint8)
    return np.unpackbits(raw, bitorder="little")[:nbits].astype(bool)


def _wr_mask(f, bits: np.ndarray):
    b = np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()
    pad = max(len(bits) // 8, 8) - len(b)
    f.write(b + b"\x00" * pad)


def _skip_metamap(f) -> dict:
    """Read a MetaMap, returning {name: raw bytes} (values unparsed)."""
    out = {}
    for _ in range(_rd(f, "I")):
        name = _rd_string(f)
        _type = _rd_string(f)
        size = _rd(f, "I")
        out[name] = (_type, f.read(size))
    return out


def _wr_metamap(f, items: list):
    """items: [(name, typeName, value bytes)]"""
    f.write(struct.pack("<I", len(items)))
    for name, tname, val in items:
        _wr_string(f, name)
        _wr_string(f, tname)
        f.write(struct.pack("<I", len(val)))
        f.write(val)


# ---------------------------------------------------------------------------
# Value-stream codec (io/Compression.h readCompressedValues semantics)


def _read_values(f, count, value_mask, compression, background, dtype):
    """Decode one mask-compressed value stream into a dense (count,)
    float32 array."""
    mask_comp = bool(compression & COMPRESS_ACTIVE_MASK)
    if compression & COMPRESS_BLOSC:
        raise ValueError(
            ".vdb uses BLOSC compression — re-save with ZIP or none "
            "(this minimal reader supports zlib only)"
        )
    metadata = _rd(f, "b")

    inactive1 = background
    inactive0 = (background if metadata == NO_MASK_OR_INACTIVE_VALS
                 else -background)
    if metadata in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
        inactive0 = np.frombuffer(f.read(dtype.itemsize), dtype)[0]
        if metadata == MASK_AND_TWO_INACTIVE_VALS:
            inactive1 = np.frombuffer(f.read(dtype.itemsize), dtype)[0]
    selection = None
    if metadata in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
        selection = _rd_mask(f, count)
        if metadata == MASK_AND_NO_INACTIVE_VALS:
            inactive0, inactive1 = -background, background

    n = int(value_mask.sum()) if (mask_comp
                                  and metadata != NO_MASK_AND_ALL_VALS) \
        else count
    nbytes = n * dtype.itemsize
    if compression & COMPRESS_ZIP:
        zipped = _rd(f, "q")
        raw = f.read(-zipped) if zipped <= 0 else zlib.decompress(
            f.read(zipped), bufsize=nbytes)
    else:
        raw = f.read(nbytes)
    vals = np.frombuffer(raw, dtype, count=n).astype(np.float32)

    dense = np.full((count,), np.float32(inactive0))
    if selection is not None:
        dense[selection] = np.float32(inactive1)
    if mask_comp and metadata != NO_MASK_AND_ALL_VALS:
        dense[value_mask] = vals
    else:
        dense = vals
    return dense


def _write_values(f, dense, value_mask, compression, dtype):
    """Encode values the way openvdb writes a fog volume: inactive
    voxels are all +background (zero), so metadata is
    NO_MASK_OR_INACTIVE_VALS and only active values are stored."""
    if compression & COMPRESS_ACTIVE_MASK:
        f.write(struct.pack("<b", NO_MASK_OR_INACTIVE_VALS))
        vals = dense[value_mask]
    else:
        f.write(struct.pack("<b", NO_MASK_AND_ALL_VALS))
        vals = dense
    raw = np.ascontiguousarray(vals, dtype).tobytes()
    if compression & COMPRESS_ZIP:
        zipped = zlib.compress(raw)
        if len(zipped) < len(raw):
            f.write(struct.pack("<q", len(zipped)))
            f.write(zipped)
        else:
            f.write(struct.pack("<q", -len(raw)))
            f.write(raw)
    else:
        f.write(raw)


# ---------------------------------------------------------------------------
# Reading


def _read_transform(f):
    """Return (scale (3,), translation (3,)): world = scale*ijk + t."""
    map_type = _rd_string(f)
    if map_type in ("ScaleTranslateMap", "UniformScaleTranslateMap"):
        t = np.array(_rd(f, "3d"))
        s = np.array(_rd(f, "3d"))
        f.read(4 * 24)            # voxel size + 3 cached inverse vectors
        return s, t
    if map_type in ("ScaleMap", "UniformScaleMap"):
        s = np.array(_rd(f, "3d"))
        f.read(4 * 24)
        return s, np.zeros(3)
    if map_type == "TranslationMap":
        return np.ones(3), np.array(_rd(f, "3d"))
    if map_type == "AffineMap":
        m = np.array(_rd(f, "16d")).reshape(4, 4)
        return np.diagonal(m[:3, :3]).copy(), m[3, :3].copy()
    raise ValueError(f".vdb transform map not supported: {map_type}")


class _GridData:
    def __init__(self):
        self.leaves = []    # (origin xyz, (8,8,8) float32 [x,y,z] order)
        self.tiles = []     # (origin xyz, span, value) active tiles only


def _read_internal(f, log2dim, child_total, origin, compression,
                   background, dtype, grid, topology):
    """topology pass: recurse; returns list of child (origin, level)."""
    size = 1 << (3 * log2dim)
    dim = 1 << log2dim
    child_mask = _rd_mask(f, size)
    value_mask = _rd_mask(f, size)
    values = _read_values(f, size, value_mask, compression, background,
                          dtype)
    # Record active constant tiles (value regions with no child).
    span = 1 << child_total
    for off in np.nonzero(value_mask & ~child_mask)[0]:
        x = (off >> (2 * log2dim)) & (dim - 1)
        y = (off >> log2dim) & (dim - 1)
        z = off & (dim - 1)
        grid.tiles.append((
            (origin[0] + x * span, origin[1] + y * span,
             origin[2] + z * span), span, float(values[off]),
        ))
    children = []
    for off in np.nonzero(child_mask)[0]:
        x = (off >> (2 * log2dim)) & (dim - 1)
        y = (off >> log2dim) & (dim - 1)
        z = off & (dim - 1)
        corg = (origin[0] + x * span, origin[1] + y * span,
                origin[2] + z * span)
        if child_total == LEAF_LOG2:
            _rd_mask(f, LEAF_SIZE)          # leaf topology = value mask
            children.append((corg, "leaf"))
        else:
            children.extend(_read_internal(
                f, INT1_LOG2, LEAF_LOG2, corg, compression, background,
                dtype, grid, topology,
            ))
    return children


def read_vdb(path: str, grid_name: str | None = None):
    """Parse a .vdb file; return the VolumeIR of the requested (or
    first) float grid."""
    from tracerboy_tpu_torch.scene.volume import VolumeIR

    with open(path, "rb") as f:
        magic = _rd(f, "q")
        if magic != MAGIC:
            raise ValueError(f"not a .vdb file: {path}")
        version = _rd(f, "I")
        if version < 220:
            raise ValueError(
                f".vdb file version {version} predates selective "
                "compression (220); not supported"
            )
        _rd(f, "II")                       # library major/minor
        _rd(f, "b")                        # has grid offsets
        archive_compression = (COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
                               if version < 223
                               else COMPRESS_BLOSC | COMPRESS_ACTIVE_MASK)
        if 220 <= version < 222:
            archive_compression = (COMPRESS_ZIP if _rd(f, "b")
                                   else COMPRESS_NONE)
        f.read(36)                         # uuid (ASCII)
        _skip_metamap(f)
        grid_count = _rd(f, "i")

        last_err = None
        for _ in range(grid_count):
            name = _rd_string(f)
            grid_type = _rd_string(f)
            instance_parent = _rd_string(f)
            _rd(f, "qqq")                  # grid/block/end offsets
            half = grid_type.endswith("_HalfFloat")
            base = name.split("\x1e")[0]   # unique-name suffix separator
            if instance_parent:
                raise ValueError(
                    ".vdb instanced grids not supported by this reader"
                )
            compression = archive_compression
            if version >= 222:
                compression = _rd(f, "I")
            meta = _skip_metamap(f)
            scale, translate = _read_transform(f)
            if "float" not in grid_type:
                raise ValueError(
                    f".vdb grid '{base}' has unsupported value type: "
                    f"{grid_type} (float fog grids only)"
                )
            if grid_name is not None and base != grid_name:
                last_err = ValueError(
                    f"grid '{grid_name}' not found in {path} "
                    f"(saw '{base}')"
                )
                # No offsets guaranteed -> cannot skip; just parse it
                # and fall through to the error at the end.
            dtype = np.dtype("<f2") if half else np.dtype("<f4")

            # Tree topology (Tree.h:1272 + RootNode.h:2254)
            if _rd(f, "i") != 1:
                raise ValueError("multi-buffer .vdb trees not supported")
            background = float(
                np.frombuffer(f.read(dtype.itemsize), dtype)[0])
            num_tiles, num_children = _rd(f, "II")
            grid = _GridData()
            for _ in range(num_tiles):
                x, y, z = _rd(f, "3i")
                val = float(np.frombuffer(f.read(dtype.itemsize), dtype)[0])
                active = _rd(f, "b")
                if active:
                    grid.tiles.append(((x, y, z), 1 << INT2_TOTAL, val))
            leaf_list = []
            for _ in range(num_children):
                x, y, z = _rd(f, "3i")
                leaf_list.extend(_read_internal(
                    f, INT2_LOG2, INT1_TOTAL, (x, y, z), compression,
                    background, dtype, grid, True,
                ))
            # Tree buffers (LeafNode.h:1412): value mask + voxel values
            for org, _tag in leaf_list:
                mask = _rd_mask(f, LEAF_SIZE)
                vals = _read_values(f, LEAF_SIZE, mask, compression,
                                    background, dtype)
                grid.leaves.append(
                    (org, vals.reshape(LEAF_DIM, LEAF_DIM, LEAF_DIM))
                )
            if grid_name is None or base == grid_name:
                bbox = None
                if ("file_bbox_min" in meta and "file_bbox_max" in meta
                        and meta["file_bbox_min"][0] == "vec3i"):
                    bbox = (
                        struct.unpack("<3i", meta["file_bbox_min"][1]),
                        struct.unpack("<3i", meta["file_bbox_max"][1]),
                    )
                return _assemble(grid, scale, translate, VolumeIR, bbox)
        raise last_err or ValueError(f"no float grid found in {path}")


def _assemble(grid: _GridData, scale, translate, VolumeIR, bbox=None):
    """Dense (D, H, W) [z, y, x] density + world bounds from decoded
    leaves and active tiles.

    bbox: optional inclusive index-space (min, max) from the grid's
    file_bbox_min/max stats metadata (what openvdb's addStatsMetadata
    records); without it the extent rounds up to whole leaf/tile boxes.
    """
    boxes = [(o, LEAF_DIM) for o, _ in grid.leaves]
    for o, span, _v in grid.tiles:
        boxes.append((o, span))
    if not boxes:
        raise ValueError(".vdb grid holds no voxels")
    if bbox is not None:
        lo_i = np.asarray(bbox[0], np.int64)
        hi_i = np.asarray(bbox[1], np.int64) + 1
    else:
        lo_i = np.min([o for o, _ in boxes], axis=0)
        hi_i = np.max([np.add(o, s) for o, s in boxes], axis=0)
    nx, ny, nz = (hi_i - lo_i).astype(int)
    density = np.zeros((nz, ny, nx), np.float32)    # [z, y, x]

    def paint(org, span_xyz, data):
        """Clipped fill of a leaf/tile box into the dense grid."""
        a = np.asarray(org) - lo_i                  # box min, grid frame
        b = a + span_xyz                            # box max (exclusive)
        ca = np.maximum(a, 0)
        cb = np.minimum(b, [nx, ny, nz])
        if (ca >= cb).any():
            return
        dst = density[ca[2]:cb[2], ca[1]:cb[1], ca[0]:cb[0]]
        if np.isscalar(data):
            dst[...] = data
        else:
            s = ca - a
            dst[...] = data.transpose(2, 1, 0)[
                s[2]:s[2] + cb[2] - ca[2],
                s[1]:s[1] + cb[1] - ca[1],
                s[0]:s[0] + cb[0] - ca[0],
            ]                                       # [x,y,z] -> [z,y,x]

    for org, span, val in grid.tiles:
        paint(org, np.full(3, span), val)
    for org, vals in grid.leaves:
        paint(org, np.full(3, LEAF_DIM), vals)
    world_lo = scale * lo_i + translate
    world_hi = scale * hi_i + translate
    return VolumeIR(
        density=density,
        lo=world_lo.astype(np.float32),
        hi=world_hi.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Writing (round-trip oracle + export; same wire format, version 224)


def write_vdb(path: str, vol, grid_name: str = "density",
              compression: int = COMPRESS_ZIP | COMPRESS_ACTIVE_MASK,
              half: bool = False):
    """Serialize a VolumeIR density grid as a version-224 .vdb FloatGrid
    (Tree_float_5_4_3; one Internal32 root child, so grids up to 4096^3).
    """
    density = np.asarray(vol.density, np.float32)   # (D, H, W) [z,y,x]
    nz, ny, nx = density.shape
    if max(nx, ny, nz) > (1 << INT2_TOTAL):
        raise ValueError("grid exceeds the single-root-child 4096^3 span")
    arr = density.transpose(2, 1, 0)                # [x, y, z]
    dtype = np.dtype("<f2") if half else np.dtype("<f4")
    scale = (np.asarray(vol.hi, np.float64) - np.asarray(vol.lo, np.float64)
             ) / np.array([nx, ny, nz], np.float64)
    translate = np.asarray(vol.lo, np.float64)

    with open(path, "wb") as f:
        f.write(struct.pack("<q", MAGIC))
        f.write(struct.pack("<I", FILE_VERSION))
        f.write(struct.pack("<II", LIB_MAJOR, LIB_MINOR))
        f.write(struct.pack("<b", 0))              # no grid offsets
        f.write(b"00000000-0000-0000-0000-000000000000")
        _wr_metamap(f, [])                         # archive metadata
        f.write(struct.pack("<i", 1))              # grid count

        gtype = "Tree_float_5_4_3" + ("_HalfFloat" if half else "")
        _wr_string(f, grid_name)
        _wr_string(f, gtype)
        _wr_string(f, "")                          # instance parent
        f.write(struct.pack("<qqq", 0, 0, 0))      # stream offsets
        f.write(struct.pack("<I", compression))
        _wr_metamap(f, [
            ("class", "string", b"fog volume"),
            ("file_bbox_max", "vec3i",
             struct.pack("<3i", nx - 1, ny - 1, nz - 1)),
            ("file_bbox_min", "vec3i", struct.pack("<3i", 0, 0, 0)),
            ("name", "string", grid_name.encode()),
        ])
        _wr_string(f, "ScaleTranslateMap")
        f.write(struct.pack("<3d", *translate))
        f.write(struct.pack("<3d", *scale))
        f.write(struct.pack("<3d", *np.abs(scale)))           # voxel size
        inv = 1.0 / scale
        f.write(struct.pack("<3d", *inv))
        f.write(struct.pack("<3d", *(inv * inv)))
        f.write(struct.pack("<3d", *(0.5 * inv)))

        # ---- tree topology
        f.write(struct.pack("<i", 1))              # buffer count
        f.write(np.zeros(1, dtype).tobytes())      # background = 0
        f.write(struct.pack("<II", 0, 1))          # tiles, children
        f.write(struct.pack("<3i", 0, 0, 0))       # root child origin

        # Occupancy: which Internal16 / leaf slots exist.
        span1 = 1 << INT1_TOTAL                    # 128 voxels
        n1 = (np.array([nx, ny, nz]) + span1 - 1) // span1
        dim2 = 1 << INT2_LOG2

        def slot_offsets(counts, log2dim):
            xs, ys, zs = [np.arange(c) for c in counts]
            gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
            return ((gx << (2 * log2dim)) + (gy << log2dim) + gz).ravel(), \
                np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

        off2, cells2 = slot_offsets(n1, INT2_LOG2)
        child2 = np.zeros(INT2_SIZE, bool)
        child2[off2] = True
        _wr_mask(f, child2)
        _wr_mask(f, np.zeros(INT2_SIZE, bool))     # no internal tiles
        _write_values(f, np.zeros(INT2_SIZE, np.float32),
                      np.zeros(INT2_SIZE, bool), compression, dtype)

        # Internal16 children in ascending offset order = x-major cells.
        order2 = np.argsort(off2)
        leaf_masks, leaf_vals = [], []
        for ci in order2:
            cx, cy, cz = cells2[ci] * span1
            lx = min((nx - cx + LEAF_DIM - 1) // LEAF_DIM, 16)
            ly = min((ny - cy + LEAF_DIM - 1) // LEAF_DIM, 16)
            lz = min((nz - cz + LEAF_DIM - 1) // LEAF_DIM, 16)
            off1, cells1 = slot_offsets((lx, ly, lz), INT1_LOG2)
            child1 = np.zeros(INT1_SIZE, bool)
            child1[off1] = True
            _wr_mask(f, child1)
            _wr_mask(f, np.zeros(INT1_SIZE, bool))
            _write_values(f, np.zeros(INT1_SIZE, np.float32),
                          np.zeros(INT1_SIZE, bool), compression, dtype)
            for li in np.argsort(off1):
                ox = cx + cells1[li][0] * LEAF_DIM
                oy = cy + cells1[li][1] * LEAF_DIM
                oz = cz + cells1[li][2] * LEAF_DIM
                block = np.zeros((LEAF_DIM, LEAF_DIM, LEAF_DIM),
                                 np.float32)
                sx = min(LEAF_DIM, nx - ox)
                sy = min(LEAF_DIM, ny - oy)
                sz = min(LEAF_DIM, nz - oz)
                block[:sx, :sy, :sz] = arr[ox:ox + sx, oy:oy + sy,
                                           oz:oz + sz]
                flat = block.ravel()               # x-major = offset order
                mask = flat != 0.0
                leaf_masks.append(mask)
                leaf_vals.append(flat)
                _wr_mask(f, mask)                  # leaf topology

        # ---- tree buffers
        for mask, flat in zip(leaf_masks, leaf_vals):
            _wr_mask(f, mask)
            _write_values(f, flat, mask, compression, dtype)
