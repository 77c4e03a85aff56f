"""The port's dense renderer against `render_jnp.render_batch` with the
walk chain on (round caps): the tests/test_torch_render.py scenes mixed
and round-capped dash, one tile each of one batch, in both precisions.
(Its fuzz scenes are in test_torch_render_dense_fuzz.py.)  Bar: byte-identical."""

import pytest

from tests.test_torch_render import scene_mixed, scene_round_capped_dash
from tests.test_torch_render_dense import CHUNK, assert_same, both

SCENES = {
    "mixed": lambda prim: scene_mixed(prim)[1],
    "round_capped_dash": lambda prim: scene_round_capped_dash(prim)[1],
}


@pytest.fixture(scope="module", params=["exact", "fast"])
def rendered(request):
    want, got, chain = both(list(SCENES.values()), 256, CHUNK, request.param)
    assert chain
    return request.param, want, got


@pytest.mark.parametrize("tile", range(len(SCENES)), ids=list(SCENES))
def test_chain_scenes_match_render_jnp(rendered, tile):
    precision, want, got = rendered
    assert_same(want[tile:tile + 1], got[tile:tile + 1], f"{precision} {list(SCENES)[tile]}")
