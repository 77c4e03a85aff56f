"""Traffic drawn from --seed: the same plan on every run of a seed, every
request drawn anew from the Zipf law over a ranking that the traffic
file fixes."""

import collections
import json
import os

import pytest

from tilebench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overview():
    with open(os.path.join(HERE, "traffic", "overview.json")) as f:
        return json.load(f)


def metro_like_keys():
    # 12 z12 and 41 z13 tiles, as the 112-block city has, at @1x and @2x.
    z12 = [(12, 2154 + i % 4, 1437 + i // 4, s) for i in range(12) for s in (1, 2)]
    z13 = [(13, 4308 + i % 7, 2874 + i // 7, s) for i in range(41) for s in (1, 2)]
    return z12 + z13


def test_hot_keys_cover_every_tile_at_each_zoom_and_scale():
    xy18 = [(x, y) for x in range(1000, 1100, 7) for y in range(2000, 2040, 9)]
    keys = traffic.hot_keys(xy18, [12, 13], [1, 2])
    want = {(z, x >> (18 - z), y >> (18 - z), s) for z in (12, 13) for x, y in xy18
            for s in (1, 2)}
    assert set(keys) == want and keys == sorted(keys)


def test_the_ranking_is_the_traffic_files_own():
    t = overview()
    ranking = traffic.ranked(metro_like_keys(), t["ranking_seed"])
    assert len(ranking) == 106 and sorted(ranking) == sorted(metro_like_keys())
    assert ranking == traffic.ranked(metro_like_keys(), t["ranking_seed"])
    assert ranking != traffic.ranked(metro_like_keys(), t["ranking_seed"] + 1)


def test_zipf_weights_over_the_106_keys():
    w = traffic.zipf_weights(106, overview()["zipf_s"])
    assert sum(w) == pytest.approx(1.0)
    assert w[0] / w[1] == pytest.approx(2.0) and w[0] / w[3] == pytest.approx(4.0)
    assert all(a > b for a, b in zip(w, w[1:]))


def test_each_request_is_drawn_from_the_law():
    t = overview()
    n = 200_000
    got = collections.Counter(traffic.request_sequence(106, t, 2**31 + 9, n))
    w = traffic.zipf_weights(106, t["zipf_s"])
    for rank in (0, 1, 2, 9, 50, 105):
        want = n * w[rank]
        assert abs(got[rank] - want) < 5 * want ** 0.5 + 5, (rank, got[rank], want)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, 4_000_000_009])
def test_plan_is_a_function_of_the_seed(seed):
    ranking = traffic.ranked(metro_like_keys(), 1729)
    a = traffic.plan(ranking, overview(), seed, 20.0)
    b = traffic.plan(ranking, overview(), seed, 20.0)
    assert a == b
    assert a["clients"] == 64 and len(a["sequence"]) >= traffic.MAX_RATE_PER_S * 20
    json.dumps(a)


def test_seeds_draw_different_requests():
    t = overview()
    a = traffic.request_sequence(106, t, 1, 10_000)
    b = traffic.request_sequence(106, t, 2, 10_000)
    assert a != b and set(a) <= set(range(106))
