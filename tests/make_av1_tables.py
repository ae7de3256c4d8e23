"""Write tracerboy_tpu_torch/csrc/av1_tables.inc: the constant tables of
the AV1 intra decoder (csrc/av1_decode.cpp), read out of the AV1 codecs'
shared libraries.

The libraries are stripped, so each table is found by its first values
(the first CDF as the AV1 specification lists it) and then walked. A CDF
is stored inverted (32768 - value) as its N-1 values, and each library
follows them with zeros of its own (libaom: the terminal 0 and the
counter, padded to 16 entries in aom 3.12; dav1d: the counter and
padding; libgav1: the terminal 0 and the counter). The walk reads N-1
non-zero, non-increasing values and skips the zeros after them.

The source is the copy of aom 3.12.1 inside Pillow's wheel
(pillow.libs/libavif-01e67780.so.16.3.0, which also holds dav1d 1.5.1).
Its block of CDFs is found from Default_Intra_Frame_Y_Mode_Cdf's first
row (15588, 17027, ...): the hit followed by a zero (0x479a80; the hit
at 0x445000 is dav1d's padded copy). Tables are looked for from 0x10000
before that hit to 0x14000 after it, where aom keeps its mode,
coefficient and motion vector CDFs. Each table is then looked up the
same way in the system's libdav1d.so.6, libaom.so.3 and libgav1.so.1: where the walk
holds there, every value must agree; where a library lays the table out
otherwise, every CDF of more than two symbols must still occur in it.

The tables that are not CDFs: Dc_Qlookup and Ac_Qlookup (8-bit) and
Dr_Intra_Derivative are int16 arrays; the smooth weights, the
filter-intra taps and the quantizer matrices (aom's iwt_matrix_ref: 15
levels x {luma, chroma} x 3344 bytes, in aom's order of transform sizes;
aom 3.12 stores a rectangular matrix column by column, which the
generator turns into the specification's rows, aom 3.6's order) are byte
arrays; each is found by its first values. The scans and
Coeff_Base_Ctx_Offset follow rules (square scans zig-zag from the right,
tall ones diagonals down-left, wide ones up-right; offsets 0, 1, 6, 21 by
row + col on squares, 11 in the first two rows of tall blocks and 16 in
the first two columns of wide ones); the generator builds them and checks
each against libgav1, which keeps the specification's layout, and the
wheel.

The in-loop filters' tables (FILTER_TABLES: the self-guided parameter
sets, the CDEF directions and chroma directions, the Wiener and
self-guided coefficient ranges) are small arrays each read from the one
library that keeps it in a layout of its own, turned into the
specification's and looked for in the layouts of the others; the
restoration CDFs are walked like the others.

Intra block copy's CDFs (the motion vector's joint, class, sign, class0
bit and bits, the var-tx split, the inter transform type sets) are
walked like the others; the sign, class0 hp, hp, class0 bit and ten bit
CDFs as the one run aom keeps them in, split after the walk. Film grain's
Gaussian sequence is dav1d's int16 array (libgav1 keeps it alike, aom
as int32), its overlap weights dav1d's SSE constants; the grain
templates' sizes are macros in every library and are written from the
specification.

    PYTHONPATH=. python tests/make_av1_tables.py          # rewrite the .inc
    PYTHONPATH=. python tests/make_av1_tables.py --check  # compare

--check exits 1 where the committed .inc differs from what the wheel
gives, or a present library disagrees; an absent library is reported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tracerboy_tpu_torch" / "csrc" / "av1_tables.inc"

WHEEL = "libavif-01e67780.so.16.3.0"
SYSTEM = ("libdav1d.so.6", "libaom.so.3", "libgav1.so.1")
SYSTEM_DIR = Path("/usr/lib/x86_64-linux-gnu")
KF_ANCHOR = (15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189,
             28165, 29093, 30466)
U5 = (6554, 13107, 19661, 26214)     # the uniform 5-symbol CDF

# (C name, shape, symbols, first values of the first CDF). Shapes are the
# specification's; TAKE_FIRST tables hold a second, unused context in aom
# (its eob CDFs of 512 and 1024 are [q][plane][2]), dropped after the walk.
CDF_TABLES = [
    ("Default_Intra_Frame_Y_Mode_Cdf", (5, 5), 13, KF_ANCHOR),
    ("Default_Uv_Mode_Cfl_Not_Allowed_Cdf", (13,), 13, (22631, 24152, 25378)),
    ("Default_Uv_Mode_Cfl_Allowed_Cdf", (13,), 14, (10407, 11208, 12900)),
    ("Default_Partition_W8_Cdf", (4,), 4, (19132, 25510, 30392)),
    ("Default_Partition_W16_Cdf", (4,), 10, (15597, 20929, 24571)),
    ("Default_Partition_W32_Cdf", (4,), 10, (18462, 20920, 23124)),
    ("Default_Partition_W64_Cdf", (4,), 10, (20137, 21547, 23078)),
    ("Default_Partition_W128_Cdf", (4,), 8, (27899, 28219, 28529)),
    ("Default_Skip_Cdf", (3,), 2, (31671,)),
    ("Default_Segment_Id_Cdf", (3,), 8, (5622, 7893, 16093)),
    ("Default_Delta_Q_Cdf", (1,), 4, (28160, 32120, 32677)),
    ("Default_Delta_Lf_Cdf", (1,), 4, (28160, 32120, 32677)),
    ("Default_Delta_Lf_Multi_Cdf", (4,), 4, (28160, 32120, 32677)),
    ("Default_Cfl_Sign_Cdf", (1,), 8, (1418, 2123, 13340)),
    ("Default_Cfl_Alpha_Cdf", (6,), 16, (7637, 20719, 31401)),
    ("Default_Palette_Y_Mode_Cdf", (7, 3), 2, (31676,)),
    # aom keeps the intrabc CDF right after the two palette UV contexts.
    ("Default_Palette_Uv_Mode_Intrabc_Cdf", (3,), 2, (32461,)),
    ("Default_Palette_Y_Size_Cdf", (7,), 7, (7952, 13000, 18149)),
    ("Default_Palette_Uv_Size_Cdf", (7,), 7, (8713, 19979, 27128)),
    ("Default_Filter_Intra_Cdfs", (22,), 2, (4621,)),
    ("Default_Filter_Intra_Mode_Cdf", (1,), 5, (8949, 12776, 17211)),
    ("Default_Angle_Delta_Cdf", (8,), 7, (2180, 5032, 7567)),
    ("Default_Tx_8x8_Cdf", (3,), 2, (19968,)),
    ("Default_Tx_16x16_Cdf", (3,), 3, (12272, 30172)),
    ("Default_Tx_32x32_Cdf", (3,), 3, (12986, 15180)),
    ("Default_Tx_64x64_Cdf", (3,), 3, (5782, 11475)),
    ("Default_Intra_Tx_Type_Set1_Cdf", (2, 13), 7, (1535, 8035, 9461)),
    ("Default_Intra_Tx_Type_Set2_Cdf", (3, 13), 5, U5),
    ("Default_Txb_Skip_Cdf", (4, 5, 13), 2, (31849,)),
    ("Default_Eob_Pt_16_Cdf", (4, 2, 2), 5, (840, 1039, 1980)),
    ("Default_Eob_Pt_32_Cdf", (4, 2, 2), 6, (400, 520, 977)),
    ("Default_Eob_Pt_64_Cdf", (4, 2, 2), 7, (329, 498, 1101)),
    ("Default_Eob_Pt_128_Cdf", (4, 2, 2), 8, (219, 482, 1140)),
    ("Default_Eob_Pt_256_Cdf", (4, 2, 2), 9, (310, 584, 1887)),
    ("Default_Eob_Pt_512_Cdf", (4, 2, 2), 10, (641, 983, 3707)),
    ("Default_Eob_Pt_1024_Cdf", (4, 2, 2), 11, (393, 421, 751)),
    ("Default_Eob_Extra_Cdf", (4, 5, 2, 9), 2, (16961,)),
    ("Default_Dc_Sign_Cdf", (4, 2, 3), 2, (16000,)),
    ("Default_Coeff_Base_Eob_Cdf", (4, 5, 2, 4), 3, (17837, 29055)),
    ("Default_Coeff_Base_Cdf", (4, 5, 2, 42), 4, (4034, 8930, 12727)),
    ("Default_Coeff_Br_Cdf", (4, 5, 2, 21), 4, (14298, 20718, 24174)),
    # The loop restoration unit types (read_lr_unit).
    ("Default_Restoration_Type_Cdf", (1,), 3, (9413, 22581)),
    ("Default_Use_Wiener_Cdf", (1,), 2, (11570,)),
    ("Default_Use_Sgrproj_Cdf", (1,), 2, (16855,)),
    # Intra block copy: the motion vector's CDFs (both MV contexts start
    # from one default, aom's default_nmv_context: sign, class0 hp, hp,
    # the class0 bit and the ten bits lie in one run, taken whole), the
    # var-tx split, and the inter transform type sets.
    ("Default_Mv_Joint_Cdf", (1,), 4, (4096, 11264, 19328)),
    ("Default_Mv_Class_Cdf", (1,), 11, (28672, 30976, 31858)),
    ("Default_Mv_Sign_To_Bits_Cdf", (14,), 2, (16384,)),
    ("Default_Txfm_Split_Cdf", (21,), 2, (28581,)),
    ("Default_Inter_Tx_Type_Set1_Cdf", (2,), 16, (4458, 5560, 7695)),
    ("Default_Inter_Tx_Type_Set2_Cdf", (1,), 12, (770, 2421, 5225)),
    ("Default_Inter_Tx_Type_Set3_Cdf", (4,), 2, (16384,)),
]
TAKE_FIRST = ("Default_Eob_Pt_512_Cdf", "Default_Eob_Pt_1024_Cdf")
# Walks that must also meet a later row: the set-2 tx types are uniform
# at 4x4 and 8x8, so the walk must reach the 16x16 rows (row 26); the
# rows after the first of some small tables pin them down.
LATER_ROWS = {
    "Default_Intra_Tx_Type_Set2_Cdf": (26, (1127, 12814, 22772, 27483)),
    "Default_Skip_Cdf": (1, (16515,)),
    "Default_Palette_Y_Mode_Cdf": (1, (3419,)),
    "Default_Palette_Uv_Mode_Intrabc_Cdf": (2, (30531,)),
    "Default_Filter_Intra_Cdfs": (1, (6743,)),
    "Default_Tx_8x8_Cdf": (2, (24320,)),
    "Default_Txb_Skip_Cdf": (1, (5892,)),
    "Default_Eob_Extra_Cdf": (1, (17223,)),
    "Default_Dc_Sign_Cdf": (1, (13056,)),
    "Default_Mv_Sign_To_Bits_Cdf": (3, (27648,)),
    "Default_Txfm_Split_Cdf": (1, (23846,)),
    "Default_Inter_Tx_Type_Set3_Cdf": (1, (4167,)),
}
# Default_Mv_Sign_To_Bits_Cdf's rows as the specification names them.
MV_BITS = {"Default_Mv_Sign_Cdf": 0, "Default_Mv_Class0_Bit_Cdf": 3,
           "Default_Mv_Bit_Cdf": slice(4, 14)}
# The palette colour-index CDFs, by palette size: 5 contexts each, the
# first CDF of each table.
PALETTE = {
    "Y": {2: (28710,), 3: (27877, 30490), 4: (25572, 28046, 30045),
          5: (24779, 26955, 28576), 6: (23132, 25407, 26970),
          7: (23105, 25199, 26464), 8: (21689, 23883, 25163)},
    "Uv": {2: (29089,), 3: (25257, 29145), 4: (24210, 27175, 29903),
           5: (22980, 25479, 27781), 6: (22217, 24567, 26637),
           7: (21239, 23168, 25044), 8: (21442, 23288, 24758)},
}
PALETTE_LATER = {("Y", 2): (1, (16384,)), ("Uv", 2): (1, (16384,))}
# Other tables: (C name, C type, count, numpy type, first values, check).
PLAIN = [
    ("Dc_Qlookup", "int16_t", 256, "<i2", (4, 8, 8, 9, 10, 11, 12, 12, 13),
     lambda t: t[-1] == 1336 and np.all(np.diff(t) >= 0)),
    ("Ac_Qlookup", "int16_t", 256, "<i2", (4, 8, 9, 10, 11, 12, 13, 14, 15),
     lambda t: t[-1] == 1828 and np.all(np.diff(t) >= 0)),
    ("Dr_Intra_Derivative", "int16_t", 90, "<i2", (0, 0, 0, 1023, 0, 0, 547),
     lambda t: t[87] == 3 and t[45] == 64),
    ("Sm_Weights", "uint8_t", 124, "u1", (255, 149, 85, 64, 255, 197, 146),
     lambda t: t[60] == 255 and t[-1] == 4),
    ("Filter_Intra_Taps8", "int8_t", 320, "i1", (-6, 10, 0, 0, 0, 12, 0, 0),
     lambda t: np.all(t.reshape(5, 8, 8)[:, :, 7] == 0)),
    ("Quantizer_Matrix", "uint8_t", 15 * 2 * 3344, "u1",
     (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150),
     lambda t: np.all(t >= 16) and np.all(t[-3344:] <= 32)),
    # Film grain (7.18.3): the Gaussian sequence (dav1d's int16 copy), and
    # the overlap weights (27, 17), (17, 27) and (23, 22) as dav1d's SSE
    # constants hold them (pb_27_17_17_27, then pb_23_22 8 bytes on).
    ("Gaussian_Sequence", "int16_t", 2048, "<i2",
     (56, 568, -180, 172, 124, -84, 172, -64, -900),
     lambda t: np.all(t % 4 == 0) and t[-1] == -484),
    ("Grain_Overlap_Weights", "uint8_t", 10, "u1",
     (27, 17, 17, 27, 0, 32, 0, 32, 23, 22), lambda t: True),
]
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
           (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]
TX_SIZES_ALL = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
                (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
                (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]


def wheel_path():
    try:
        import PIL
    except ImportError:
        return None
    p = Path(PIL.__file__).resolve().parent.parent / "pillow.libs" / WHEEL
    return p if p.exists() else None


def walk(a, i, count, n):
    """count CDFs of n symbols from u16 index i of a; their specification
    values (the last, 32768, included), or None where the layout breaks."""
    out = []
    for _ in range(count):
        vals = a[i:i + n - 1].astype(np.int64)
        if (len(vals) < n - 1 or np.any(vals == 0)
                or np.any(np.diff(vals) > 0)):
            return None
        out.append(tuple(int(v) for v in 32768 - vals) + (32768,))
        i += n - 1
        if i >= len(a) or a[i] != 0:
            return None
        while i < len(a) and a[i] == 0:
            i += 1
    return out


def find_cdfs(data, count, n, first, later=None, lo=0, hi=None):
    """(offset, CDFs) of the first place in data[lo:hi] where a CDF
    starting with `first` begins a walk of count CDFs that holds (and
    meets `later`: (row, first values)); None if there is none."""
    a16 = np.frombuffer(data[:len(data) // 2 * 2], dtype="<u2")
    pat = np.array([32768 - v for v in first], dtype="<u2").tobytes()
    hi = len(data) if hi is None else hi
    i = data.find(pat, lo, hi)
    while i >= 0:
        if i % 2 == 0:
            cdfs = walk(a16, i // 2, count, n)
            if cdfs is not None and (
                    later is None
                    or cdfs[later[0]][:len(later[1])] == tuple(later[1])):
                return i, cdfs
        i = data.find(pat, i + 1, hi)
    return None


def find_plain(data, count, dtype, first, check, lo=0, hi=None):
    pat = np.array(first, dtype=dtype).tobytes()
    size = np.dtype(dtype).itemsize
    hi = len(data) if hi is None else hi
    i = data.find(pat, lo, hi)
    while i >= 0:
        t = np.frombuffer(data[i:i + count * size], dtype=dtype)
        if len(t) == count and check(t):
            return i, t.astype(np.int64)
        i = data.find(pat, i + 1, hi)
    return None


def all_tables():
    """[(C name, shape, symbols, first, later)]: every CDF table walked."""
    out = [(name, shape, n, first, LATER_ROWS.get(name))
           for name, shape, n, first in CDF_TABLES]
    for plane, sizes in PALETTE.items():
        for size, first in sizes.items():
            out.append((f"Default_Palette_Size_{size}_{plane}_Color_Cdf",
                        (5,), size, first, PALETTE_LATER.get((plane, size))))
    return out


def wheel_copies(data):
    """[(offset, lo, hi)]: the wheel's copies of the CDFs, found from the
    kf y-mode row, the later one (aom's) first; each spans 0x10000 bytes
    before its hit to 0x14000 after."""
    pat = np.array([32768 - v for v in KF_ANCHOR], dtype="<u2").tobytes()
    hits, i = [], data.find(pat)
    while i >= 0:
        hits.append((i, i - 0x10000, i + 0x14000))
        i = data.find(pat, i + 1)
    if not hits:
        raise SystemExit("the wheel holds no kf y-mode CDFs")
    return hits[::-1]


QM_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
            (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]


def qm_rows(t):
    """aom 3.12's iwt_matrix_ref with each rectangular matrix turned from
    aom 3.12's column-by-column order into the rows of the specification
    (and of aom 3.6): [level][plane][3344]."""
    t = t.reshape(15, 2, 3344).copy()
    off = 0
    for w, h in QM_SIZES:
        blk = t[:, :, off:off + w * h]
        if w != h:
            t[:, :, off:off + w * h] = (
                blk.reshape(15, 2, w, h).transpose(0, 1, 3, 2).reshape(15, 2, -1))
        off += w * h
    return t.reshape(-1)


def read_tables(libs):
    """{name: (where, offset, values)}: each CDF table from the first
    place where its walk holds in full: the wheel's copies, then the
    system libraries in the order of libs; the plain tables from the
    wheel."""
    places = [(f"wheel@{hex(h)}", "wheel", lo, hi)
              for h, lo, hi in wheel_copies(libs["wheel"])]
    places += [(lib, lib, 0, None) for lib in libs if lib != "wheel"]
    got = {}
    for name, shape, n, first, later in all_tables():
        for where, lib, lo, hi in places:
            hit = find_cdfs(libs[lib], int(np.prod(shape)), n, first, later,
                            lo, hi)
            if hit is not None:
                got[name] = (where, hit[0], hit[1])
                break
        else:
            raise SystemExit(f"{name}: found in no library")
    for name, ctype, count, dtype, first, check in PLAIN:
        hit = find_plain(libs["wheel"], count, dtype, first, check)
        if hit is None:
            raise SystemExit(f"{name}: not found in the wheel")
        t = qm_rows(hit[1]) if name == "Quantizer_Matrix" else hit[1]
        got[name] = ("wheel", hit[0], t)
    return got


def scan(w, h):
    """The specification's default scan of a w x h block: positions r*w+c."""
    out = []
    for s in range(w + h - 1):
        cells = [(r, s - r) for r in range(h) if 0 <= s - r < w]
        if w == h:
            cells = cells[::-1] if s % 2 == 0 else cells
        elif w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


def ctx_offset(w, h):
    """Coeff_Base_Ctx_Offset of a w x h transform: [5][5]."""
    t = np.zeros((5, 5), np.int64)
    for r in range(min(5, h)):
        for c in range(min(5, w)):
            if r == 0 and c == 0:
                v = 0
            elif w == h:
                v = 1 if r + c < 2 else (6 if r + c < 4 else 21)
            elif w > h:
                v = 16 if c < 2 else (6 if r + c < 4 else 21)
            else:
                v = 11 if r < 2 else (6 if r + c < 4 else 21)
            t[r, c] = v
    return t


def rule_tables():
    scans = {f"Default_Scan_{w}x{h}": np.array(scan(w, h)) for w, h in TX_DIMS}
    offs = np.stack([ctx_offset(w, h) for w, h in TX_SIZES_ALL])
    return scans, offs


def check_rules(libs):
    """Where each rule-built table occurs; the names of those that occur
    in no library."""
    scans, offs = rule_tables()
    missing = []
    for name, s in scans.items():
        pat = s.astype("<i2").tobytes()
        where = [k for k, d in libs.items() if d.find(pat) >= 0]
        print(f"  {name}: in {', '.join(where) or 'no library'}")
        if not where:
            missing.append(name)
    # libgav1 keeps the 19 [5][5] tables in its own order of sizes
    # (by width, then height).
    order = sorted(range(len(TX_SIZES_ALL)), key=lambda k: TX_SIZES_ALL[k])
    pat = offs[order].astype("i1").tobytes()
    where = [nm for nm, d in libs.items() if d.find(pat) >= 0]
    print(f"  Coeff_Base_Ctx_Offset: in {', '.join(where) or 'no library'}")
    if not where:
        missing.append("Coeff_Base_Ctx_Offset")
    return missing


# The in-loop filters' small tables, each read from one library in that
# library's layout and turned into the specification's, then looked for
# in the layouts of the others. Sgr_Params is aom's av1_sgr_params
# ({r0, r1}, {s0, s1} a set; the specification's rows are {r0, s0, r1,
# s1}); dav1d and libgav1 keep only the s pairs, 0 where r is 0.
# Cdef_Uv_Dir is aom's conv440 and conv422 with the identity rows of
# 4:2:0 and 4:4:4; dav1d keeps the identity and the 4:2:2 row; libgav1
# the whole [subX][subY][dir] table. Cdef_Directions is dav1d's
# dav1d_cdef_directions (offsets in a block 12 wide, directions 6, 7,
# 0-7, 0, 1), decoded into {dy, dx}; aom keeps the offsets in a block
# 144 wide, libgav1 the specification's table. The Wiener tap limits are
# libgav1's (max then min), the Wiener tap midpoints aom's default
# filter (3, -7, 15, then 106 = 128 - 2 (3 - 7 + 15)), the self-guided
# projection limits aom 3.6's (min then max) and midpoints its reference
# SgrprojInfo. Wiener_Taps_K is a run too short to find: written from the
# specification.


def aligned(data, arr, lo=0):
    """The offsets of arr's bytes in data at the alignment of its type."""
    b, size = arr.tobytes(), arr.dtype.itemsize
    out, i = [], data.find(b, lo)
    while i >= 0:
        if i % size == 0:
            out.append(i)
        i = data.find(b, i + 1)
    return out


def sgr_from_aom(t):
    t = t.reshape(16, 2, 2)
    return np.stack([t[:, 0, 0], t[:, 1, 0], t[:, 0, 1], t[:, 1, 1]], 1)


def sgr_s_only(s):
    return np.where(s[:, [0, 2]] == 0, 0, s[:, [1, 3]])


def uvdir_from_aom(t):
    ident = np.arange(8)
    return np.array([[ident, t[:8]], [t[8:], ident]])


def dirs_from_dav1d(t):
    o = t.reshape(12, 2)[2:10]
    dy = np.round(o / 12).astype(np.int64)
    return np.stack([dy, o - 12 * dy], -1)


def dirs_as_offsets(s, stride, pad):
    o = s[..., 0] * stride + s[..., 1]
    return np.concatenate([o[8 - pad:], o, o[:pad]]) if pad else o


# (C name, C type, source library, its layout's first values, dtype,
# index of the table in the run, count, to the specification's layout,
# [(library, dtype, the specification's table in its layout)]).
FILTER_TABLES = [
    ("Sgr_Params", "int16_t", "wheel", (2, 1, 140, 3236), "<i4", 0, 64,
     sgr_from_aom,
     [("libaom.so.3", "<i4", lambda s: s[:, [0, 2, 1, 3]]),
      ("wheel", "<u2", sgr_s_only), ("libdav1d.so.6", "<u2", sgr_s_only),
      ("libgav1.so.1", "<u2", sgr_s_only)]),
    ("Cdef_Uv_Dir", "uint8_t", "wheel", (1, 2, 2, 2, 3, 4, 6, 0, 7), "<i4",
     0, 16, uvdir_from_aom,
     [("libaom.so.3", "<i4", lambda s: np.concatenate([s[0, 1], s[1, 0]])),
      ("wheel", "u1", lambda s: np.concatenate([s[0, 0], s[1, 0]])),
      ("libdav1d.so.6", "u1", lambda s: np.concatenate([s[0, 0], s[1, 0]])),
      ("libgav1.so.1", "u1", lambda s: s)]),
    ("Cdef_Directions", "int8_t", "wheel", (12, 24, 12, 23, -11, -22), "i1",
     0, 24, dirs_from_dav1d,
     [("libdav1d.so.6", "i1", lambda s: dirs_as_offsets(s, 12, 2)),
      ("wheel", "<i4", lambda s: dirs_as_offsets(s, 144, 0)),
      ("libaom.so.3", "<i4", lambda s: dirs_as_offsets(s, 144, 0)),
      ("libgav1.so.1", "i1", lambda s: s)]),
    ("Wiener_Taps_Min", "int8_t", "libgav1.so.1", (10, 8, 46, -5), "i1", 3,
     3, None, []),
    ("Wiener_Taps_Max", "int8_t", "libgav1.so.1", (10, 8, 46, -5), "i1", 0,
     3, None, []),
    ("Wiener_Taps_Mid", "int8_t", "wheel", (3, -7, 15, 106), "<i4", 0, 3,
     None, [("libaom.so.3", "<i4",
             lambda s: np.append(s, 128 - 2 * s.sum()))]),
    ("Sgrproj_Xqd_Min", "int8_t", "libaom.so.3", (-96, -32, 31, 95), "<i4",
     0, 2, None, []),
    ("Sgrproj_Xqd_Max", "int8_t", "libaom.so.3", (-96, -32, 31, 95), "<i4",
     2, 2, None, []),
    ("Sgrproj_Xqd_Mid", "int8_t", "libaom.so.3", (-32, 31), "<i4", 0, 2,
     None, [("libgav1.so.1", "<i4", lambda s: s)]),
]
SPEC_ONLY = {"Wiener_Taps_K": ("int8_t", np.array([1, 2, 3])),
             # The grain templates' heights and widths, whole and
             # subsampled (dav1d's GRAIN_HEIGHT, GRAIN_WIDTH and their SUB_
             # twins are macros).
             "Grain_Block_Size": ("uint8_t", np.array([[73, 82], [38, 44]]))}


def read_filter_tables(libs):
    """{name: (where, offset, values)} of FILTER_TABLES."""
    got = {}
    for name, ctype, lib, first, dtype, start, count, conv, _ in \
            FILTER_TABLES:
        if lib not in libs:
            raise SystemExit(f"{name}: {lib} is absent")
        size = np.dtype(dtype).itemsize
        for off in aligned(libs[lib], np.array(first, dtype)):
            t = np.frombuffer(libs[lib][off:off + (start + count) * size],
                              dtype).astype(np.int64)[start:]
            if len(t) == count:
                got[name] = (lib, off + start * size,
                             conv(t) if conv else t)
                break
        else:
            raise SystemExit(f"{name}: not found in {lib}")
    return got


def check_filter_tables(libs, got):
    """Each table in the other layouts: prints where it is found; returns
    the names of those whose first values are found with other values
    after them."""
    bad = []
    for name, ctype, lib, first, dtype, start, count, conv, views in \
            FILTER_TABLES:
        for where, vtype, fn in views:
            if where not in libs:
                continue
            want = np.asarray(fn(got[name][2])).astype(vtype)
            head = aligned(libs[where], want.reshape(-1)[:4])
            full = aligned(libs[where], want)
            state = ("equal" if full else "differs" if head
                     else "laid out otherwise")
            print(f"  {name} in {where} ({np.dtype(vtype).name}): {state}"
                  + (f" at {hex(full[0])}" if full else ""))
            if head and not full:
                bad.append(f"{name} in {where}")
    return bad


def cross_check(got, data, lo=0, hi=None, wheel=None):
    """(compared, disagreeing, unrecognised) table names of one library
    (or one copy in the wheel, data[lo:hi]) against the tables read: a
    table is compared where its walk holds there."""
    compared, bad, unknown = [], [], []
    for name, shape, n, first, later in all_tables():
        cdfs = got[name][2]
        hit = find_cdfs(data, len(cdfs), n, first, later, lo, hi)
        if hit is None:
            unknown.append(name)
        elif hit[1] != cdfs:
            bad.append(f"{name} at {hex(hit[0])}")
        else:
            compared.append(name)
    for name, ctype, count, dtype, first, check in PLAIN:
        hit = find_plain(data, count, dtype, first, check, lo, hi)
        if hit is not None and name == "Quantizer_Matrix" and data is wheel:
            hit = (hit[0], qm_rows(hit[1]))
        if hit is None:
            unknown.append(name)
        elif not np.array_equal(hit[1], got[name][2]):
            bad.append(f"{name} at {hex(hit[0])}")
        else:
            compared.append(name)
    return compared, bad, unknown


def c_array(name, ctype, arr, per_line=16):
    dims = "".join(f"[{d}]" for d in arr.shape)
    flat = [str(int(v)) for v in arr.reshape(-1)]
    lines = [", ".join(flat[i:i + per_line])
             for i in range(0, len(flat), per_line)]
    return (f"static const {ctype} {name}{dims} = {{\n  "
            + ",\n  ".join(lines) + "\n};\n")


def cdf_array(cdfs, shape, n):
    """The specification's CDF arrays with a counter slot: [..][n + 1]."""
    return np.array([list(c) + [0] for c in cdfs]).reshape(*shape, n + 1)


def render(got, got_filters):
    head = [
        "// Generated by tests/make_av1_tables.py; do not edit. CDFs are the",
        "// specification's (not inverted), each followed by 32768 and a",
        "// counter slot. Where each table was read: 'wheel@' a copy in",
        f"// Pillow's pillow.libs/{WHEEL} (aom 3.12.1's, then",
        "// dav1d 1.5.1's), else a system library. Every table is checked",
        "// against the wheel, libaom.so.3, libgav1.so.1 and libdav1d.so.6.",
    ]
    body = []
    for name, shape, n, first, later in all_tables():
        lib, off, cdfs = got[name]
        arr = cdf_array(cdfs, shape, n)
        if name in TAKE_FIRST:
            arr = arr[:, :, 0]
        head.append(f"//   {name}: {lib} {hex(off)}")
        if name == "Default_Mv_Sign_To_Bits_Cdf":
            for part, rows in MV_BITS.items():
                body.append(c_array(part, "uint16_t", arr[rows]))
            continue
        if name == "Default_Palette_Uv_Mode_Intrabc_Cdf":
            body.append(c_array("Default_Palette_Uv_Mode_Cdf", "uint16_t",
                                arr[:2]))
            body.append(c_array("Default_Intrabc_Cdf", "uint16_t", arr[2]))
            continue
        body.append(c_array(name, "uint16_t", arr))
    for name, ctype, count, dtype, first, check in PLAIN:
        lib, off, t = got[name]
        head.append(f"//   {name}: {lib} {hex(off)}")
        if name == "Filter_Intra_Taps8":
            body.append(c_array("Filter_Intra_Taps", "int8_t",
                                t.reshape(5, 8, 8)[:, :, :7]))
            continue
        if name == "Grain_Overlap_Weights":
            body.append(c_array(name, ctype, t[[0, 1, 2, 3, 8, 9]]
                                .reshape(3, 2)))
            continue
        body.append(c_array(name, ctype, t, 32 if count > 1000 else 16))
    for name, (lib, off, t) in got_filters.items():
        ctype = next(f[1] for f in FILTER_TABLES if f[0] == name)
        head.append(f"//   {name}: {lib} {hex(off)}")
        body.append(c_array(name, ctype, np.asarray(t)))
    for name, (ctype, t) in SPEC_ONLY.items():
        head.append(f"//   {name}: from the specification (in no library "
                    "as an array)")
        body.append(c_array(name, ctype, t))
    scans, offs = rule_tables()
    head.append("// Default scans and Coeff_Base_Ctx_Offset: built by rule "
                "and found in libgav1.so.1.")
    for name, s in scans.items():
        body.append(c_array(name, "uint16_t", s))
    body.append(c_array("Coeff_Base_Ctx_Offset", "uint8_t", offs, 25))
    return "\n".join(head) + "\n\n" + "\n".join(body)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    wp = wheel_path()
    if wp is None:
        raise SystemExit(f"Pillow's {WHEEL} is not installed")
    libs = {"wheel": wp.read_bytes()}
    for lib in ("libaom.so.3", "libgav1.so.1", "libdav1d.so.6"):
        p = SYSTEM_DIR / lib
        if p.exists():
            libs[lib] = p.read_bytes()
        else:
            print(f"{lib}: absent, not checked")
    got = read_tables(libs)
    got_filters = read_filter_tables(libs)
    text = render(got, got_filters)
    failed = False
    places = [(f"wheel@{hex(h)}", libs["wheel"], lo, hi)
              for h, lo, hi in wheel_copies(libs["wheel"])]
    places += [(lib, libs[lib], 0, None) for lib in libs if lib != "wheel"]
    for where, data, lo, hi in places:
        compared, bad, unknown = cross_check(got, data, lo, hi,
                                             wheel=libs["wheel"])
        print(f"{where}: {len(compared)} tables equal, {len(bad)} differ, "
              f"{len(unknown)} laid out otherwise")
        for b in bad:
            print("    differs:", b)
        if unknown:
            print("    not compared:", ", ".join(unknown))
        failed |= bool(bad)
    print("in-loop filter tables:")
    bad = check_filter_tables(libs, got_filters)
    for b in bad:
        print("    differs:", b)
    failed |= bool(bad)
    print("rule-built tables:")
    failed |= bool(check_rules(libs))
    if args.check:
        same = OUT.exists() and OUT.read_text() == text
        print(f"{OUT.relative_to(ROOT)}: "
              f"{'equal to' if same else 'DIFFERS from'} the wheel's tables")
        failed |= not same
        return 1 if failed else 0
    OUT.write_text(text)
    print(f"wrote {OUT.relative_to(ROOT)} ({len(text)} bytes)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
