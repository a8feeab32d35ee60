"""The frames the check samples: k of each size, from the whole window,
the same for one seed, copied into buffers made in set-up."""

import collections
from typing import NamedTuple

import torch

from benchmark import harness


class Result(NamedTuple):
    disparity: torch.Tensor
    other: torch.Tensor


def frame(i, size):
    return harness.Frame(i % 3, size, 7, 0.0, 0.0, 0.0)


def sampled(seed, n=60, k=2, sizes=((4, 5), (3, 6))):
    s = harness.Sampler(seed, k, ["disparity"])
    for size in sizes:
        s.reserve(size, Result(torch.zeros(size), torch.zeros(1)))
    for i in range(n):
        size = sizes[i % len(sizes)]
        s.offer(i, frame(i, size), Result(torch.full(size, float(i)),
                                          torch.zeros(1)))
    return s


def test_k_of_each_size_with_their_own_maps():
    s = sampled(2 ** 31 + 1)
    got = s.samples()
    assert len(got) == 4
    assert collections.Counter(tuple(m["disparity"].shape)
                               for _, _, m in got) == {(4, 5): 2, (3, 6): 2}
    for i, pair, maps in got:
        assert pair == i % 3 and torch.equal(maps["disparity"],
                                             torch.full_like(maps["disparity"], i))
        assert set(maps) == {"disparity"}


def test_one_seed_one_sample_and_the_whole_window_drawn():
    assert [x[0] for x in sampled(7).samples()] == [
        x[0] for x in sampled(7).samples()]
    picks = collections.Counter(i for seed in range(400)
                                for i, _, _ in sampled(seed, k=1).samples())
    # Every frame can be drawn, the last ones as often as the first.
    assert set(picks) == set(range(60))
    early = sum(picks[i] for i in range(20))
    late = sum(picks[i] for i in range(40, 60))
    assert 0.6 < early / late < 1.6
