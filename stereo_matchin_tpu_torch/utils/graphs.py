"""Whole frames captured as CUDA graphs: the port's counterpart of
`jax.jit` over the JAX package's frame entries (`asw_pipeline`,
`cross_pipeline`, `asw_pipeline_batched`).

`replay(fn, tensors, statics)` computes `fn(*tensors, *statics)`:

  * on CPU tensors it calls fn, with no `torch.cuda` call at all;
  * on CUDA tensors it replays the graph of the call's `signature` (fn,
    each tensor's shape, dtype and device, and the hashable static
    arguments: a frozen StereoConfig, a crop), as XLA traces once per
    signature and then runs the executable.  The first call of a
    signature copies the tensors into static buffers, runs fn once on a
    side stream (the warm-up: it builds and loads the kernels, warms the
    allocator and measures the frame's peak), then captures fn into a
    private memory pool.  Every call copies the caller's tensors into the
    static buffers, replays on the current stream and returns a new
    result of fn's NamedTuple type with every field cloned: a result the
    caller holds is never overwritten by a later call, as each call of a
    jitted function returns fresh arrays.

Only the shapes and the static arguments may steer fn from the host: a
value fn read from a tensor while it was captured would be frozen into
the graph.  A capture that fails raises; nothing runs the eager frame in
its place (the eager chains keep their JAX names, `*_impl`).

Launch counts stay true.  The kernel wrappers count `kernels.LAUNCHES` in
Python, which a replay does not run: the capture's count is kept as one
frame's and added once per replay, and the counters are put back as they
were before the warm-up and the capture.  So every call, the first one
included, counts exactly one frame.

Memory: a graph's pool holds its frame's peak while the graph lives, and
each call's clones are as large as the frame's result; a frame's
footprint is the two together.  The cache keeps at most MAX_GRAPHS
graphs, least recently used evicted first, and makes room before each of
the two steps of a first call that allocate a frame's worth:

  * before the warm-up, it evicts the oldest graphs while the card's free
    memory is below the largest footprint in the cache (a new signature
    is sized as the largest one held); a warm-up that still runs out of
    memory evicts the oldest graph and runs again, until none is left;
  * before the capture, while the free memory is below the warm-up's
    measured peak plus POOL_MARGIN of it (a pool also keeps the blocks the
    frame freed inside it) plus the bytes of the result (the first
    replay's clones).

The first call of a signature resets the card's peak-memory statistic
(the warm-up's peak is measured from it).  `clear_caches()` drops every
graph, as `jax.clear_caches` drops the compiled programs.

Calls may come from different streams: each call waits for the previous
call's replay and clones before it overwrites the static inputs.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from .. import kernels

MAX_GRAPHS = 4
# A pool's bytes above its warm-up's peak: 4-17% on the card (PERF.md,
# section 5), so a quarter.
POOL_MARGIN = 0.25


def signature(fn, tensors, statics) -> tuple:
    """The cache key of one call: the entry, each tensor's shape, dtype and
    device, and the static arguments."""
    return (fn, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
            tuple(statics))


def launch_delta(before: dict, after: dict) -> dict:
    """The launches counted between two snapshots of kernels.LAUNCHES."""
    return {k: after[k] - before[k] for k in after}


def add_launches(counts: dict, delta: dict) -> None:
    for k, v in delta.items():
        counts[k] += v


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def capture_need(warm: dict) -> int:
    """The free bytes a capture needs: the pool (the warm-up's peak and
    POOL_MARGIN of it) and the first replay's clones."""
    peak = warm["warmup_peak_bytes"]
    return peak + int(peak * POOL_MARGIN) + warm["output_bytes"]


class CapturedFrame:
    """One signature's graph, its static input and output tensors, the
    launches of one frame, and what its first call measured (seconds of
    warm-up and of capture, the warm-up's peak bytes, the result's bytes,
    the pool's bytes)."""

    def __init__(self, graph, inputs, output, launches, stats):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.launches, self.stats = launches, stats
        self.done = torch.cuda.Event()      # the last call's clones

    @property
    def footprint(self) -> int:
        """The bytes the frame holds on the card: its pool, and the clones
        of a call whose result the caller keeps."""
        return self.stats["pool_bytes"] + self.stats["output_bytes"]

    def __call__(self, tensors):
        stream = torch.cuda.current_stream()
        stream.wait_event(self.done)
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)
        self.graph.replay()
        add_launches(kernels.LAUNCHES, self.launches)
        out = type(self.output)(*(t.clone() for t in self.output))
        self.done.record(stream)
        return out


def warm_up(fn, inputs, statics, dev) -> dict:
    """Run fn once on a side stream of `dev` (it builds and loads the
    kernels and warms the allocator; its result is dropped).  Returns its
    seconds, its peak bytes above those allocated before it, the bytes of
    its result and its launches; the launch counters are put back."""
    before = dict(kernels.LAUNCHES)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = fn(*inputs, *statics)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        return {"warmup_s": time.perf_counter() - t0,
                "warmup_peak_bytes": torch.cuda.max_memory_allocated(dev)
                - base, "output_bytes": nbytes(out),
                "launches": launch_delta(before, kernels.LAUNCHES)}
    finally:
        kernels.LAUNCHES.update(before)


def capture(fn, inputs, statics, dev, warm) -> CapturedFrame:
    """Capture fn on `inputs` into a private pool (after warm_up, as
    torch.cuda.graph's documentation does it); the launch counters are put
    back."""
    before = dict(kernels.LAUNCHES)
    try:
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            output = fn(*inputs, *statics)
        capture_s = time.perf_counter() - t0
        launches = launch_delta(before, kernels.LAUNCHES)
    finally:
        kernels.LAUNCHES.update(before)
    if launches != warm["launches"]:
        raise RuntimeError(f"{getattr(fn, '__name__', fn)}: the capture "
                           f"launched {launches}, the warm-up "
                           f"{warm['launches']}")
    stats = {k: v for k, v in warm.items() if k != "launches"}
    return CapturedFrame(graph, inputs, output, launches, stats | {
        "capture_s": capture_s,
        "pool_bytes": torch.cuda.memory_reserved(dev) - reserved})


class GraphCache:
    """The captured frames by signature, least recently used first."""

    def __init__(self):
        self.frames = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        """The frame of `key` (now the most recently used), or None."""
        frame = self.frames.get(key)
        if frame is not None:
            self.frames.move_to_end(key)
        return frame

    def put(self, key, frame) -> None:
        self.frames[key] = frame
        self.frames.move_to_end(key)

    def evict_oldest(self) -> None:
        """Drop the least recently used frame; its pool goes back to the
        card."""
        self.frames.popitem(last=False)
        torch.cuda.empty_cache()

    def evict_to(self, count: int) -> None:
        """Evict the oldest frames until at most `count` are left."""
        while len(self.frames) > count:
            self.evict_oldest()

    def largest_footprint(self) -> int:
        return max((f.footprint for f in self.frames.values()), default=0)

    def make_room(self, need: int, device) -> None:
        """Release cached blocks, then evict the oldest graphs while the
        card has less than `need` bytes free."""
        torch.cuda.empty_cache()
        while self.frames and torch.cuda.mem_get_info(device)[0] < need:
            self.evict_oldest()

    def clear(self) -> None:
        self.evict_to(0)

    def first_call(self, fn, tensors, statics, dev) -> CapturedFrame:
        """Make room, warm up, make room, capture (the module's docstring
        says how much room)."""
        self.evict_to(MAX_GRAPHS - 1)
        self.make_room(self.largest_footprint(), dev)
        inputs = tuple(t.clone() for t in tensors)
        while True:
            try:
                warm = warm_up(fn, inputs, statics, dev)
                break
            except torch.cuda.OutOfMemoryError:
                # The warm-up's result is never used, so a run that did not
                # fit is dropped and run again with one graph fewer.
                if not self.frames:
                    raise
            self.evict_oldest()
        self.make_room(capture_need(warm), dev)
        return capture(fn, inputs, statics, dev, warm)

    def __call__(self, fn, tensors, statics):
        if not any(t.is_cuda for t in tensors):
            return fn(*tensors, *statics)
        key = signature(fn, tensors, statics)
        dev = next(t.device for t in tensors if t.is_cuda)
        with self._lock, torch.cuda.device(dev):
            frame = self.get(key)
            if frame is None:
                frame = self.first_call(fn, tensors, statics, dev)
                self.put(key, frame)
            return frame(tensors)


CACHE = GraphCache()


def replay(fn, tensors, statics=()):
    """fn(*tensors, *statics) through the process's graph cache."""
    return CACHE(fn, tensors, statics)


def clear_caches() -> None:
    """Drop every captured frame and release its pool."""
    CACHE.clear()
