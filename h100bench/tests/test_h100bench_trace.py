"""busy_s, window_s and what is read from a synthetic trace."""

from h100bench.trace import Trace, union


def test_union_merges_overlaps_and_keeps_gaps():
    assert union([(5, 9), (0, 3), (2, 4), (8, 12), (20, 21), (21, 22)]) == [(0, 4), (5, 12), (20, 22)]


def test_busy_is_the_clipped_union_of_overlapping_device_ops():
    device = [("a", 50, 150, (1, 0)),     # starts before the span: clipped to 100
              ("b", 120, 300, (2, 0)),    # overlaps a
              ("c", 250, 280, (3, 0)),    # inside b
              ("d", 400, 500, (4, 0)),    # after a gap of 100
              ("e", 950, 1100, (5, 0)),   # ends after the span: clipped to 1000
              ("f", 2000, 2100, (6, 0))]  # outside the span
    t = Trace(device, [], {}, (100, 1000))
    assert t.window_s == 900 / 1e9
    assert t.busy_s == (200 + 100 + 50) / 1e9
    assert 0 < t.busy_s <= t.window_s


def test_breakdown_names_gaps_by_the_innermost_open_host_op():
    device = [("k1", 0, 100, (1, 0)), ("k2", 300, 400, (2, 0)), ("k1", 450, 500, (3, 0))]
    host = [("outer", 0, 1000, 7), ("inner", 90, 350, 7)]
    t = Trace(device, host, {}, (0, 500))
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "k1" and abs(bd["device_ops"][0][1] - 150e-9) < 1e-15
    assert bd["idle_gaps"][0] == ["inner", 200e-9]
    assert bd["idle_gaps"][1] == ["outer", 50e-9]


def test_device_ops_are_attributed_to_the_range_that_launched_them():
    device = [("x", 100, 200, (11, 0)), ("y", 300, 400, (0, 12)), ("z", 500, 600, (13, 0))]
    host = [("h100bench.forward", 0, 50, 1), ("h100bench.forward", 250, 280, 1)]
    launches = {11: (10, 1), 12: (260, 1), 13: (900, 1)}
    t = Trace(device, host, launches, (0, 1000))
    under = t.device_under("h100bench.forward")
    assert [[op[0] for op in ops] for ops in under] == [["x"], ["y"]]

