"""The frozen roofline arithmetic against hand-worked cases."""
import pytest

from ptbench import roofline as rl


def test_peaks():
    assert rl.F32_OPS_PER_S == pytest.approx(33.45408e12)
    assert rl.PEAK_BYTES == 3.35e12


def test_forward_ops_by_hand():
    # one sample, 2 bounces on a scene of a plane and a sphere, 1 hit:
    # 44 + 2 x (14 + 62) + (33 + 125) = 354
    counts = {"samples": 1, "bounces": 2, "hits": 1}
    assert rl.forward_ops(counts, (rl.PLANE, rl.SPHERE)) == 354
    # the walk: 3 nodes and 8 slots add 3 x 22 + 8 x 34 = 338
    walk = dict(counts, node_visits=3, leaf_slots=8)
    assert rl.forward_ops(walk, (rl.PLANE, rl.SPHERE)) == 354 + 338


def test_bound_takes_the_larger_time():
    t, by = rl.bound_of(33.45408e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = rl.bound_of(1.0, 6.7e12)
    assert t == pytest.approx(2.0) and by == "bytes"
