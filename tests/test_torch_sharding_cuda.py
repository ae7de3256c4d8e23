"""Tile and sample sharding (parallel/sharding.py) on the card, on the
mesh ["cuda:0", "cuda:0"] (two entries on one card, each rendering its
own replica of the scene):

- tiles at 64x48 (pad 0) and 63x47 (pad 1): the accumulators after
  render_sample(1) twice equal (torch.equal) an unsharded renderer's
  after as many render_sample(1) calls, and the traversal kernels
  launched;
- spp render_sample(4) (one merged 2-sample wave an entry): equal to the
  unsharded merged waves at sample bases 0 and 2, summed in mesh order;
- the replicas refreshed after update_geometry (the card's LBVH
  rebuild): the tiled render after it equals the unsharded one;
- make_mesh asked for one card more than the machine has raises.

Every test is under the `cuda` marker (skipped without a card). This
module imports no jax: `python -m pytest --noconftest -m cuda
tests/test_torch_sharding_cuda.py`.
"""

import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.parallel.sharding import make_mesh
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.trace.wavefront import render_wave_merged


@pytest.fixture
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return make_mesh(devices=["cuda:0", "cuda:0"])


@pytest.mark.cuda
@pytest.mark.parametrize("film", [(64, 48), (63, 47)])
def test_tiles_equal_the_unsharded_waves(pair, film):
    ref = Renderer("shadertoy", film_size=film, device="cuda")
    r = Renderer("shadertoy", film_size=film, device="cuda", shard="tiles",
                 mesh=pair)
    assert r.traversal == "kernel"
    kernels.reset_counters()
    for _ in range(2):
        r.render_sample(1)
    assert kernels.LAUNCHES["closest"] > 0 and kernels.LAUNCHES["anyhit"] > 0
    for _ in range(2):
        ref.render_sample(1)
    assert r._tiled_pixels[1] == (-film[0] * film[1]) % 2
    assert torch.equal(r.state.accum, ref.state.accum)
    assert torch.equal(r.state.accum_jittered, ref.state.accum_jittered)


@pytest.mark.cuda
def test_spp_equals_its_mesh_order_sum(pair):
    film = (64, 48)
    r = Renderer("shadertoy", film_size=film, device="cuda", shard="spp",
                 mesh=pair)
    r.render_sample(4)
    ref = Renderer("shadertoy", film_size=film, device="cuda")
    cfg, params = ref.wave_config(), ref.frame_params()
    outs = [render_wave_merged(ref.scene, params, ref.pixel_ids, 2 * i, 2,
                               cfg) for i in range(2)]
    rad = outs[0]["radiance"] + outs[1]["radiance"]
    fw = outs[0]["filter_weight"] + outs[1]["filter_weight"]
    want = torch.cat([rad.reshape(film[1], film[0], 3),
                      fw.reshape(film[1], film[0], 1)], -1)
    assert r.state.spp == 4 and torch.equal(r.state.accum, want)


@pytest.mark.cuda
def test_replicas_refresh_after_update_geometry(pair):
    film = (64, 48)
    r = Renderer("shadertoy", film_size=film, device="cuda", shard="tiles",
                 mesh=pair)
    ref = Renderer("shadertoy", film_size=film, device="cuda")
    r.render_sample(1)
    stale = r._mesh_scenes()[1]
    for x in (r, ref):
        sc = x.scene
        shift = torch.tensor([0.0, 0.1, 0.0], device="cuda")
        x.update_geometry(sc["tri_v0"] + shift, sc["tri_v1"] + shift,
                          sc["tri_v2"] + shift)
    r.render_sample(1)
    ref.render_sample(1)
    fresh = r._mesh_scenes()[1]
    assert fresh is not stale
    assert torch.equal(fresh["pk_nodes"], r.scene["pk_nodes"])
    assert fresh["pk_nodes"].data_ptr() != r.scene["pk_nodes"].data_ptr()
    assert torch.equal(r.state.accum, ref.state.accum)


@pytest.mark.cuda
def test_too_many_cards_raise(pair):
    with pytest.raises(ValueError, match="visible"):
        make_mesh(n_devices=torch.cuda.device_count() + 1)
