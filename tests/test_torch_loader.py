"""The port's prefetching pair loader (io/loader.py) on the CPU: the same
images in the same order as the JAX engine's `runtime.loader.PairLoader`
with device_put off, its contract (a worker's exception re-raised in the
consumer, an early close ending the worker, `len`), and `run` decoding
through it with maps equal to the pipelines' on pairs decoded inline.
`run`'s decode path on the card is in tests/test_torch_cuda.py."""

from __future__ import annotations

import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from runtime.loader import PairLoader as JaxPairLoader
from stereo_matchin_tpu_torch import StereoConfig
from stereo_matchin_tpu_torch import io as tio
from stereo_matchin_tpu_torch import ops as tops
from stereo_matchin_tpu_torch.__main__ import _load, main
from stereo_matchin_tpu_torch.io import PairLoader, png
from stereo_matchin_tpu_torch.io.loader import DEPTH, JOIN_TIMEOUT_S
from stereo_matchin_tpu_torch.models import asw, cross_based

from .torch_support import unorm8_pair

SIZES = [(17, 23), (30, 41), (9, 12), (24, 32), (13, 50)]


@pytest.fixture
def pairs(tmp_path):
    """Five seeded PNG pairs of different sizes, as (left, right) paths."""
    out = []
    for k, (H, W) in enumerate(SIZES):
        left, right = unorm8_pair(np.random.default_rng(40 + k), H, W)
        d = tmp_path / f"pair{k}"
        d.mkdir()
        png.write_rgb(d / "l.png", left)
        png.write_rgb(d / "r.png", right)
        out.append((str(d / "l.png"), str(d / "r.png")))
    return out


def _workers():
    return [t for t in threading.enumerate() if t.name == "PairLoader"]


def _no_worker_within(seconds):
    deadline = time.monotonic() + seconds
    while _workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _workers()


@pytest.mark.parametrize("count", [1, DEPTH, 5])
def test_same_images_in_the_same_order_as_the_jax_loader(pairs, count):
    """Fewer pairs than the queue holds, as many, and more."""
    pairs = pairs[:count]
    want = list(JaxPairLoader(pairs, depth=DEPTH, device_put=False))
    got = list(PairLoader(pairs))
    assert len(got) == len(want) == len(pairs)
    for (gl, gr), (wl, wr), (lp, rp) in zip(got, want, pairs):
        for g, w, path in ((gl, wl, lp), (gr, wr, rp)):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, png.read_rgb(path))
    assert _no_worker_within(5)


def test_len_counts_the_pairs(pairs):
    assert len(PairLoader(pairs)) == len(pairs)
    assert len(PairLoader([])) == 0 and list(PairLoader([])) == []


@pytest.mark.parametrize("at", [0, 2])
@pytest.mark.parametrize("fault", ["missing", "corrupt"])
def test_a_worker_exception_is_raised_in_the_consumer(pairs, tmp_path,
                                                      fault, at):
    """A bad right view in the first or the third pair: the pairs before it
    arrive, then its decode error."""
    bad = tmp_path / "bad.png"
    if fault == "corrupt":
        bad.write_bytes(b"\x89PNG\r\n\x1a\n not a png")
    broken = pairs[:at] + [(pairs[at][0], str(bad))] + pairs[at + 1:]
    it = iter(PairLoader(broken))
    assert len([next(it) for _ in range(at)]) == at
    with pytest.raises(FileNotFoundError if fault == "missing" else OSError):
        next(it)
    assert _no_worker_within(5)


def _long(pairs):
    """Forty pairs: more than the worker decodes before the queue fills."""
    return (pairs * 8)[:40]


def test_closing_early_ends_the_worker(pairs):
    """A consumer that stops after one pair of forty: close() drains the
    queue and joins the worker well inside the deadline."""
    it = iter(PairLoader(_long(pairs)))
    next(it)
    time.sleep(0.1)                  # the worker blocks on the full queue
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < min(5.0, JOIN_TIMEOUT_S)
    assert not _workers()


def test_a_dropped_iterator_ends_the_worker(pairs):
    """An iterator dropped after one pair closes when it is collected,
    which ends its worker as close() does."""
    for _ in range(2):
        it = iter(PairLoader(_long(pairs)))
        next(it)
        del it
    assert _no_worker_within(5)


def test_consumers_under_fast_thread_switches_keep_order(pairs):
    """Eight consumers, each with its own loader over forty pairs, under a
    short switch interval: each sees its pairs in order, and every worker
    ends when its consumer closes."""
    want = [png.read_rgb(lp) for lp, _ in pairs]
    errors = []

    def consume(k):
        it = iter(PairLoader(_long(pairs)))
        try:
            for i, (left, _) in enumerate(itertools.islice(it, 12 + k)):
                if not np.array_equal(left, want[i % len(want)]):
                    errors.append((k, i))
        finally:
            it.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert _no_worker_within(5)


SMALL = ["--d_max", "11", "--radius", "2", "--r_iters", "1", "--k_iters",
         "1", "--arm_len", "4", "--device", "cpu"]


def test_run_decodes_ahead_and_writes_the_pipelines_maps(tmp_path, pairs,
                                                         monkeypatch):
    """`run --device cpu` over four pairs builds one PairLoader over their
    paths, and every artifact equals the pipelines' maps on the pairs
    decoded inline (`_load`)."""
    made = []

    class Recording(PairLoader):
        def __init__(self, pairs):
            super().__init__(pairs)
            made.append(pairs)

    monkeypatch.setattr(tio, "PairLoader", Recording)
    pics = tmp_path / "pics.txt"
    pics.write_text("".join(f"{lp}\n{rp}\n" for lp, rp in pairs[:4]))
    out = tmp_path / "out"
    assert main(["run", "--pics", str(pics), "--out", str(out)] + SMALL) == 0
    assert made == [pairs[:4]]
    cfg = StereoConfig(d_max=11, radius=2, r_iters=1, k_iters=1, arm_len=4)
    for k in range(4):
        pair = tio.StereoPair(f"pair{k}", *pairs[k])
        left, right = _load(pair, torch.device("cpu"))
        cross = cross_based.cross_pipeline(left, right, cfg)
        res = asw.asw_pipeline(left, right, cfg)
        d = out / f"pair{k}"
        for name, img in (("cross_based_initial.png", cross.initial),
                          ("cross_based_disparity.png", cross.final),
                          ("asw_disparity.png", res.disparity)):
            got = torch.from_numpy(png.read_gray(str(d / name)))
            assert torch.equal(tops.unorm8_code(got),
                               tops.unorm8_code(img)), (k, name)
        for name, img in (("median.png", cross.median_left),
                          ("asw_consistency_pre-reff.png",
                           res.consistency_pre),
                          ("asw_consistency_post-reff.png",
                           res.consistency_post)):
            np.testing.assert_array_equal(png.read_rgb(str(d / name)),
                                          img.numpy(), err_msg=f"{k} {name}")
    assert _no_worker_within(5)


def test_run_stops_at_a_pair_that_fails_to_decode(tmp_path, pairs):
    """A missing file of the second pair: `run` writes the first pair's
    maps, then the decode error reaches the caller and the worker ends."""
    pics = tmp_path / "pics.txt"
    pics.write_text(f"{pairs[0][0]}\n{pairs[0][1]}\n"
                    f"{pairs[1][0]}\n{tmp_path / 'gone.png'}\n")
    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError):
        main(["run", "--pics", str(pics), "--out", str(out), "--method",
              "cross"] + SMALL)
    assert (out / "pair0" / "cross_based_disparity.png").exists()
    assert not (out / "pair1" / "cross_based_disparity.png").exists()
    assert _no_worker_within(5)
