"""PLY mesh reader (binary little/big endian + ascii).

Replaces the reference's vendored rply usage
(PBRTParser/impl/3rdParty/rply.c, wired in semantic/Geometry.cpp). Handles
the property layouts the bundled scenes use: per-vertex float x/y/z with
optional nx/ny/nz normals and u/v (or s/t) texture coordinates, and faces as
`property list <count_t> <index_t> vertex_indices` with triangles or quads
(quads are triangulated as a fan).

A numpy copy of tracerboy_tpu/scene/ply.py.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns (positions f32 (V,3), indices i32 (T,3), normals|None, uvs|None)."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.index(b"end_header")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace").splitlines()
    if header[0].strip() != "ply":
        raise ValueError(f"not a PLY file: {path}")

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) | ('__list__', count_t, idx_t, name)])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("__list__", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))  # (name, type)
        elif parts[0] in ("comment", "obj_info"):
            continue

    if fmt == "ascii":
        return _read_ascii(data[end:].decode("ascii", errors="replace"), elements)
    endian = "<" if fmt == "binary_little_endian" else ">"
    return _read_binary(data, end, elements, endian)


def _read_binary(data, offset, elements, endian):
    positions = normals = uvs = None
    indices = None
    pos = offset
    for name, count, props in elements:
        if all(p[0] != "__list__" for p in props):
            np_dtype = np.dtype(
                [(pname, endian + _DTYPES[ptype]) for pname, ptype in props]
            )
            arr = np.frombuffer(data, np_dtype, count=count, offset=pos)
            pos += np_dtype.itemsize * count
            if name == "vertex":
                positions, normals, uvs = _extract_vertex(arr)
        else:
            # Element with a list property (faces). Fast path: uniform
            # triangle/quad lists detected from the first entry.
            lp = next(p for p in props if p[0] == "__list__")
            count_dt = np.dtype(endian + _DTYPES[lp[1]])
            idx_dt = np.dtype(endian + _DTYPES[lp[2]])
            if len(props) != 1:
                raise ValueError("mixed face properties unsupported")
            first_n = int(
                np.frombuffer(data, count_dt, count=1, offset=pos)[0]
            )
            stride = count_dt.itemsize + first_n * idx_dt.itemsize
            block = np.frombuffer(data, np.uint8, count=count * stride, offset=pos)
            counts = block.reshape(count, stride)[:, : count_dt.itemsize].copy().view(count_dt)[:, 0]
            if np.all(counts == first_n):
                pos += count * stride
                idx = (
                    block.reshape(count, stride)[:, count_dt.itemsize :]
                    .copy()
                    .view(idx_dt)
                    .reshape(count, first_n)
                    .astype(np.int64)
                )
                indices = _fan_triangulate(idx)
            else:
                # Variable-length lists: slow path
                tris = []
                p = pos
                for _ in range(count):
                    n = int(np.frombuffer(data, count_dt, count=1, offset=p)[0])
                    p += count_dt.itemsize
                    face = np.frombuffer(data, idx_dt, count=n, offset=p).astype(np.int64)
                    p += n * idx_dt.itemsize
                    for k in range(1, n - 1):
                        tris.append((face[0], face[k], face[k + 1]))
                pos = p
                indices = np.asarray(tris, np.int64)
            if name != "face":
                indices = None  # ignore non-face list elements
    return (
        positions,
        None if indices is None else indices.astype(np.int32),
        normals,
        uvs,
    )


def _read_ascii(text, elements):
    tokens = text.split()
    ti = 0
    positions = normals = uvs = None
    indices = None
    for name, count, props in elements:
        if all(p[0] != "__list__" for p in props):
            n_props = len(props)
            vals = np.array(tokens[ti : ti + count * n_props], np.float64).reshape(
                count, n_props
            )
            ti += count * n_props
            if name == "vertex":
                rec = {pname: vals[:, k] for k, (pname, _) in enumerate(props)}
                positions, normals, uvs = _extract_vertex_dict(rec)
        else:
            tris = []
            for _ in range(count):
                n = int(tokens[ti]); ti += 1
                face = [int(t) for t in tokens[ti : ti + n]]
                ti += n
                for k in range(1, n - 1):
                    tris.append((face[0], face[k], face[k + 1]))
            if name == "face":
                indices = np.asarray(tris, np.int64)
    return (
        positions,
        None if indices is None else indices.astype(np.int32),
        normals,
        uvs,
    )


def _fan_triangulate(idx: np.ndarray) -> np.ndarray:
    n = idx.shape[1]
    if n == 3:
        return idx
    tris = []
    for k in range(1, n - 1):
        tris.append(np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=1))
    return np.concatenate(tris, axis=0)


def _extract_vertex(arr):
    names = arr.dtype.names
    rec = {n: arr[n].astype(np.float32) for n in names}
    return _extract_vertex_dict(rec)


def _extract_vertex_dict(rec):
    positions = np.stack(
        [rec["x"], rec["y"], rec["z"]], axis=-1
    ).astype(np.float32)
    normals = None
    if all(k in rec for k in ("nx", "ny", "nz")):
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=-1).astype(
            np.float32
        )
    uvs = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in rec and vkey in rec:
            uvs = np.stack([rec[ukey], rec[vkey]], axis=-1).astype(np.float32)
            break
    return positions, normals, uvs
