"""The idle share's arithmetic: the union of overlapping device intervals,
the gaps between them, and the spans' reduction."""

import pytest

from portbench import trace


def test_union_counts_overlaps_once():
    # two kernels overlapping by 5 ns, a copy inside the first, one apart
    intervals = [(0, 10), (5, 20), (2, 4), (30, 40)]
    assert trace.union_seconds(intervals) == pytest.approx(30e-9)
    assert sum(e - s for s, e in intervals) == 37          # the sum over-counts


def test_gaps_between_the_union():
    intervals = [(0, 10), (5, 20), (30, 40)]
    assert trace.gaps(intervals, -5, 50) == [(-5, 0), (20, 30), (40, 50)]


def test_idle_share_of_a_window():
    intervals = [(100, 400), (300, 600), (800, 900)]
    busy = trace.union_seconds(intervals)
    assert 1 - busy / 1000e-9 == pytest.approx(0.4)


def test_host_op_is_the_innermost():
    host = [('outer', 0, 100), ('inner', 40, 60)]
    assert trace.host_op_at(host, 50) == 'inner'
    assert trace.host_op_at(host, 80) == 'outer'
    assert trace.host_op_at(host, 200) == 'no host op'


def test_spans_reduce_per_unit():
    spans = trace.Spans(True, 'cpu')
    for _ in range(2):
        spans.begin()
        spans.mark('a')
        spans.mark('a')
        spans.mark('a')
        spans.mark('a')
        spans.end()
    rows = spans.reduce()
    assert len(rows) == 2
    for row in rows:
        assert set(row) == {'unit', 'a', 'a.last_end_to_unit_end'}
        assert 0 <= row['a'] <= row['unit']
