"""The plain closest- and any-hit twins' top-down (ray, cluster) pairing
(trace/traverse.py _chunks, _pairs, check_table) against the exhaustive
pairing it replaced (utils/plain_pairing.py exhaustive_chunks: every live
ray against every cluster box), which stays here as the oracle.

On the packed tables of shadertoy, the Cornell box and the demo scene's
env.pbrt (both the main and the shadow tables), with grazing rays (origins
on a cluster box's face, directions in its plane), axis-parallel rays
(zero direction components, which fix_dir makes +-1e-12), rays through
box corners, dead lanes and short t_max: the same pairs, and
closest_hit_plain and anyhit_plain torch.equal to the twins on the
exhaustive pairs. check_table holds on every table these scenes build and
on the device-built BVH, and raises where an inner slot's box is shrunk
below its child's.
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.trace import traverse
from tracerboy_tpu_torch.utils.plain_pairing import exhaustive, pair_sets


def scene_tables(scene):
    """Every (nodes, tris_bw) table the renderer's scene compile builds."""
    sc = Renderer(scene, film_size=(16, 12), device="cpu").scene
    return [(sc[k], sc[k[:-5] + "tris_bw"]) for k in sorted(sc)
            if k.endswith("nodes") and k[:-5] + "tris_bw" in sc]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    env, _ = write_demo_scene(str(tmp_path_factory.mktemp("demo")))
    out = {}
    for name in ("shadertoy", "shadertoy:cornell", env):
        for k, (nodes, tris) in enumerate(scene_tables(name)):
            out[f"{name.rsplit('/', 1)[-1]}#{k}"] = (nodes, tris)
    return out


def hard_rays(nodes, tris, seed, n=4096):
    """Rays that graze, run parallel to axes or pass through corners of
    the table's cluster boxes, plus random rays; dead lanes and short
    t_max among them."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = traverse.cluster_boxes(nodes, tris.shape[0])
    C = lo.shape[0]
    pick = torch.randint(0, C, (n,), generator=g)
    blo, bhi = lo[pick], hi[pick]
    f = torch.rand(n, 3, generator=g)
    inside = blo + f * (bhi - blo)
    axis = torch.randint(0, 3, (n,), generator=g)
    o = inside.clone()
    d = torch.randn(n, 3, generator=g)
    kind = torch.arange(n) % 4
    rows = torch.arange(n)
    # 0: on a face plane, the direction in that plane (grazing)
    g0 = kind == 0
    face = torch.where(torch.rand(n, 1, generator=g) < 0.5, blo, bhi)
    o[rows[g0], axis[g0]] = face[rows[g0], axis[g0]]
    d[rows[g0], axis[g0]] = 0.0
    # 1: axis-parallel from outside the box, through its inside
    g1 = kind == 1
    d[g1] = 0.0
    d[rows[g1], axis[g1]] = 1.0
    o[rows[g1], axis[g1]] = blo[rows[g1], axis[g1]] - 1.0
    # 2: from a random origin through a box corner
    g2 = kind == 2
    span = (hi.max(0).values - lo.min(0).values).clamp_min(1.0)
    start = lo.min(0).values - span + torch.rand(n, 3, generator=g) * 3 * span
    o[g2] = start[g2]
    d[g2] = torch.where(torch.rand(n, 3, generator=g) < 0.5, blo, bhi)[
        g2] - start[g2]
    # 3: random origins and directions
    o[kind == 3] = start[kind == 3]
    t_max = torch.full((n,), 1e30)
    t_max[::9] = 0.0
    t_max[1::7] = torch.rand(len(t_max[1::7]), generator=g)
    return o.float(), d.float(), t_max


@pytest.mark.parametrize("seed", [0, 1])
def test_top_down_pairs_and_results_are_exhaustive(tables, seed):
    for name, (nodes, tris) in tables.items():
        o, d, t_max = hard_rays(nodes, tris, seed)
        exh, top = pair_sets(o, d, t_max, nodes, tris)
        assert exh.numel() > 0, name
        assert torch.equal(exh, top), name
        got_c = traverse.closest_hit_plain(o, d, t_max, nodes, tris)
        got_a = traverse.anyhit_plain(o, d, t_max, nodes, tris)
        with exhaustive():
            ref_c = traverse.closest_hit_plain(o, d, t_max, nodes, tris)
            ref_a = traverse.anyhit_plain(o, d, t_max, nodes, tris)
        assert all(torch.equal(a, b) for a, b in zip(got_c, ref_c)), name
        assert torch.equal(got_a, ref_a), name
        assert (got_c[1] >= 0).any() and got_a.any(), name


def test_check_table_holds_on_the_test_tables(tables):
    """The scenes' tables and a device-built BVH of the env scene's
    triangles pass; the check is kept once a table."""
    from tracerboy_tpu_torch.accel.bvh_device import (
        build_bvh_device,
        pack_for_pallas_device,
    )

    for name, (nodes, tris) in tables.items():
        traverse.check_table(nodes, tris.shape[0])
        assert traverse._CHECKED[id(nodes), tris.shape[0]]() is nodes, name
    r = Renderer("shadertoy", film_size=(16, 12), device="cpu")
    sc = r.scene
    v = [torch.as_tensor(sc[k], dtype=torch.float32)
         for k in ("tri_v0", "tri_v1", "tri_v2")]
    built = pack_for_pallas_device(build_bvh_device(*v), *v)
    traverse.check_table(built["nodes"], built["tris_bw"].shape[0])


def test_check_table_raises_on_a_slot_that_does_not_contain_its_child(
        tables):
    nodes, tris = tables["shadertoy#0"]
    bad = nodes.clone()
    lo, hi, child = traverse.slot_boxes(bad)
    p, s = ((child >= 0) & (child != int(traverse.INVALID))).nonzero(
        as_tuple=True)
    box = bad[p[0], :48].view(torch.float32).reshape(6, 8)
    box[3:6, s[0]] = box[0:3, s[0]]       # hi = lo: the slot is a point
    with pytest.raises(ValueError, match="does not contain"):
        traverse.check_table(bad, tris.shape[0])
    with pytest.raises(ValueError, match="does not contain"):
        traverse.closest_hit_plain(*hard_rays(nodes, tris, 0, 64), bad, tris)


def test_check_table_raises_on_a_missing_cluster(tables):
    nodes, tris = tables["shadertoy:cornell#0"]
    extra = torch.cat([tris, tris[:1]])
    with pytest.raises(ValueError, match="exactly"):
        traverse.check_table(nodes, extra.shape[0])
    np.testing.assert_equal(traverse.cluster_boxes(nodes, extra.shape[0])[0][
        -1].numpy(), np.full(3, traverse.BIG, np.float32))
