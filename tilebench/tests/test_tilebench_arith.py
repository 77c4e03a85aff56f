"""Rate, share and roofline arithmetic over whole windows: a stall inside
the window moves every one of them."""

import numpy as np
import pytest

from tilebench import bounds, pngdec, readers, trace
from tilebench.run import Window


def rec(sent, done, status=200):
    return [0, 0, sent, done, status, 100, "d"]


def closed_window(stall_s=0.0):
    # 10 s window from t0 = 100; one answer every 10 ms, and no answer
    # at all during a stall.
    t0, out, t = 100.0, [], 100.0
    while t < 110.0:
        if not (105.0 <= t < 105.0 + stall_s):
            out.append(rec(t, t + 0.01))
        t += 0.01
    return Window(seconds=10.0, t0=t0, records=out, setup_s=1.0)


def test_tiles_per_s_counts_the_whole_window():
    assert readers.tiles_per_s(closed_window()) == pytest.approx(100.0, abs=0.2)
    assert readers.tiles_per_s(closed_window(stall_s=2.0)) == pytest.approx(80.0, abs=0.2)


def test_answers_outside_the_window_or_failed_do_not_count():
    w = closed_window()
    w.records += [rec(110.5, 110.6), rec(99.0, 99.5), rec(101, 101.1, status=0)]
    assert readers.tiles_per_s(w) == pytest.approx(100.0, abs=0.2)


def test_trace_busy_idle_and_names():
    ns = 1_000_000_000
    ops = [("render_kernel(Params)", 0, ns // 10), ("wire_kernel", ns // 10, ns // 5),
           ("render_kernel(Params)", 5 * ns, 5 * ns + ns // 2), ("memcpy", -ns, ns // 20)]
    host = [("batch", 0, 6 * ns), ("encode", ns, 4 * ns)]
    red = trace.reduce(ops, host, 0, 10 * ns)
    assert red["window_s"] == 10.0
    assert red["busy_s"] == pytest.approx(0.7)
    assert red["by_name"]["memcpy"] == pytest.approx(0.05)
    assert trace.kernel_s(red["by_name"], "render_kernel") == pytest.approx(0.6)
    names = dict((round(s, 3), n) for n, s in red["idle_gaps"])
    assert names[4.8] == "encode" and names[4.5] == trace.NO_CALL
    # A stall with the device idle moves the idle share.
    w = Window(seconds=10.0, t0=0.0, records=[], setup_s=0.0, trace=red)
    assert readers.device_idle_share(w) == pytest.approx(93.0)


def test_roofline_is_bound_over_kernel_time_and_silent_without_kernels():
    red = {"by_name": {"render_kernel": 0.5, "wire_kernel": 0.1}, "render_bound_s": 0.01,
           "wire_bound_s": 0.03, "busy_s": 0.6, "window_s": 10.0}
    w = Window(seconds=10.0, t0=0.0, records=[], setup_s=0.0, trace=red)
    assert readers.render_roofline(w) == pytest.approx(2.0)
    assert readers.wire_roofline(w) == pytest.approx(30.0)
    red["by_name"] = {}
    assert readers.render_roofline(w) is None and readers.wire_roofline(w) is None
    assert readers.render_roofline(Window(1.0, 0.0, [], 0.0)) is None


def test_render_bound_counts_each_input_once_and_the_output():
    C, T, ts = 16, 2, 256
    packed = np.zeros((16 + bounds.NSEC, C), np.int32)
    packed[bounds.P_KIND, :8] = bounds.KIND_FILL
    packed[bounds.P_CNT, :8] = 100
    packed[bounds.P_LAST, 7] = 1
    packed[bounds.P_PRIM_NB, 7] = 2
    packed[bounds.P_PAT] = -1
    want = (4 * bounds.NCI * C + 4 * bounds.NCF * 8 + 12 + 8 * T + T * 4 * ts * ts
            + 12 * 800 + 4 * 8)
    assert bounds.render_bound_s(packed, 0, ts, T) == pytest.approx(want / bounds.HBM_BYTES_PER_S)
    assert bounds.wire_bound_s("v2", T, ts, 1000) == pytest.approx(
        (3 * T * ts * ts + 4 * 255 + 4 * (3 + T + 255) + 2000) / bounds.HBM_BYTES_PER_S)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (256, 256), (512, 512)])
def test_png_encode_round_trips(shape):
    rgb = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    assert np.array_equal(pngdec.decode(pngdec.encode(rgb)), rgb)
