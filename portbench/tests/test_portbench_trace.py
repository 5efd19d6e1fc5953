"""The reduction of a device trace, on made-up events."""

import pytest

from portbench import trace as tr


def test_busy_union_launches_and_idle_by_stage():
    marks = tr.Marks()
    marks.t, marks.names = [150, 400], ["conv", "stoc"]
    evs = [(110, 20, "k_a"), (120, 30, "k_b"),      # overlap: busy 110-150
           (200, 50, "Memcpy HtoD"), (300, 10, "k_a")]
    red = tr.reduce_events(evs, 100, 500, marks)
    assert red["launches"] == 3
    assert red["busy_s"] == pytest.approx((40 + 50 + 10) / 1e9)
    assert red["window_s"] == pytest.approx(400 / 1e9)
    assert red["by_name"]["k_a"] == [2, pytest.approx(30 / 1e9)]
    # a gap belongs to the stage that the first mark at or after its
    # start ends: 100-110 and 150-200 to "conv", 250-300 and 310-500 to
    # "stoc"
    assert red["idle_by_stage"]["conv"] == pytest.approx((10 + 50) / 1e9)
    assert red["idle_by_stage"]["stoc"] == pytest.approx((50 + 190) / 1e9)
    assert red["clock_aligned"]
    assert sum(red["idle_by_stage"].values()) + red["busy_s"] == \
        pytest.approx(red["window_s"])


def test_unaligned_clock_is_named():
    marks = tr.Marks()
    marks.t, marks.names = [10], ["conv"]
    red = tr.reduce_events([(5, 1, "k")], 100, 200, marks)
    assert list(red["idle_by_stage"]) == ["unaligned clock"]


def test_breakdown_keeps_ten_of_each():
    red = dict(by_name={f"void k{i}": [1, i / 10] for i in range(12)},
               idle_by_stage={f"s{i}": i for i in range(12)})
    b = tr.breakdown(red)
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
    assert b["device_ops"][0] == ["k11", 1.1]
    assert b["idle_gaps"][0] == ["s11", 11]
