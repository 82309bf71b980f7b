"""The pose order of each traffic mix."""

import pytest

from portbench import traffic
from portbench.registry import Bench


@pytest.mark.parametrize("seed", [0, 1, 2, 2 ** 31 + 5, 4294967301])
def test_seq99_stride3_covers_the_sequence_every_three_calls(seed):
    mix = Bench().traffic("seq99_stride3")
    calls = [traffic.call_poses(mix, seed, k) for k in range(3)]
    o = seed % 3
    assert calls[0] == list(range(o, 99, 3))
    assert all(len(c) == 33 for c in calls)
    assert sorted(sum(calls, [])) == list(range(99))
    assert calls[1][0] == (o + 1) % 3


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 1])
def test_seq99_is_the_whole_sequence_in_order(seed):
    mix = Bench().traffic("seq99")
    for k in range(3):
        assert traffic.call_poses(mix, seed, k) == list(range(99))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 2])
def test_close6_repeats_the_last_six_poses(seed):
    mix = Bench().traffic("close6_x3")
    assert traffic.call_poses(mix, seed, 0) == list(range(93, 99)) * 3


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 4])
def test_close6_x16_repeats_the_last_six_poses_sixteen_times(seed):
    mix = Bench().traffic("close6_x16")
    for k in range(2):
        assert traffic.call_poses(mix, seed, k) == list(range(93, 99)) * 16
