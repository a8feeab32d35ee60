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

Stages captured as CUDA graphs: the port's counterpart of the JAX
package's stage-level jits (`bench/harness.py` `_asw_stage_jits`,
`models/cross_based.py` `_arms_stage` .. `_median_stage`).  `STAGES` is a
stage runner with the pipelines' `run(name, fn, *args)` contract
(`replay_stage`): on CPU tensors it calls fn; on CUDA tensors it replays
the graph of the call's `stage_key` (the stage's name; fn, a
functools.partial by its function, arguments and keywords; each tensor's
shape, dtype and device; every other argument by its type and value), as
XLA compiles a jitted stage once per signature.  The pipelines build a
fresh partial on every call, so fn's identity could not key it.  A first
call warms fn up on the caller's own tensors, makes room (below),
captures fn into the pool every stage graph of a device shares, and
replays it; every call returns clones (`clone_result`: tensors, tuples
and NamedTuples, nested, each of its own type).

A frame runs tens of stages, so stage graphs share what frames keep
apart:

  * static inputs: the k-th tensor of one shape, dtype and device in a
    call takes the k-th slot of that kind, one buffer for every graph
    (the calls are ordered by one event, as a frame's are);
  * memory: each graph's outputs go back to the shared pool once it is
    captured and are read through views that do not own their memory
    (`borrowed`), so a later capture reuses them; every call clones its
    outputs before the next replay writes the pool, so the graphs may
    replay in any order.  The pool holds about the largest stage's peak,
    not the sum of the stages' outputs.

Memory is made before a capture as for a frame (`capture_need` plus the
new slots' bytes): the oldest captured frames go first, then every stage
graph at once (they share one pool).  A warm-up that runs out of memory
frees the same way and runs again.  The stage runner never runs inside a
capture: the eager chains (`asw_pipeline_impl`, `cross_pipeline_impl`)
keep `utils.call_stage` as their runner, since the frame entries capture
them whole.
"""

from __future__ import annotations

import collections
import functools
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


def map_tensors(fn, out):
    """`out` with fn applied to each tensor in it: a tensor, or tuples of
    them (NamedTuples keep their type), nested; anything else is returned
    as it is."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(map_tensors(fn, v) for v in out))
    if isinstance(out, tuple):
        return tuple(map_tensors(fn, v) for v in out)
    return out


def leaves(out) -> list:
    """The tensors in `out` (map_tensors' nesting), in order."""
    found = []
    map_tensors(found.append, out)
    return found


def clone_result(out):
    """A copy of `out` with every tensor cloned and every container of its
    own type: what a call returns, never written by a later replay."""
    return map_tensors(torch.Tensor.clone, out)


def borrowed(t: torch.Tensor) -> torch.Tensor:
    """A view of t's memory that does not own it: t's blocks may go back
    to its pool while the view still reads them."""
    storage = t.untyped_storage()
    alias = torch._C._construct_storage_from_data_pointer(
        storage.data_ptr(), t.device, storage.nbytes())
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        alias, t.storage_offset(), t.shape, t.stride())


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tensors))


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

    def load(self, tensors) -> None:
        """Wait for the last call's clones, then copy the call's tensors
        into the static inputs."""
        torch.cuda.current_stream().wait_event(self.done)
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)

    def replay(self) -> None:
        self.graph.replay()
        add_launches(kernels.LAUNCHES, self.launches)

    def result(self):
        """Clones of the outputs (clone_result); the next call waits for
        them."""
        out = clone_result(self.output)
        self.done.record(torch.cuda.current_stream())
        return out

    def __call__(self, tensors):
        self.load(tensors)
        self.replay()
        return self.result()


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


def capture(fn, inputs, statics, dev, warm, pool=None) -> CapturedFrame:
    """Capture fn on `inputs` into a private pool, or into `pool` (a
    torch.cuda.graph_pool_handle), after warm_up, as torch.cuda.graph's
    documentation does it; the launch counters are put back."""
    before = dict(kernels.LAUNCHES)
    try:
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
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


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        return (torch.Tensor, tuple(a.shape), a.dtype, a.device)
    return (type(a), a)


def _fn_key(fn):
    if not isinstance(fn, functools.partial):
        return fn
    bound = (*fn.args, *fn.keywords.values())
    if any(isinstance(a, torch.Tensor) for a in bound):
        raise ValueError(f"{fn}: a stage's partial binds a tensor, which its "
                         f"graph would read from where it was captured; pass "
                         f"it as an argument")
    return (functools.partial, _fn_key(fn.func),
            tuple(_arg_key(a) for a in fn.args),
            tuple(sorted((k, _arg_key(v)) for k, v in fn.keywords.items())))


def stage_key(name: str, fn, args) -> tuple:
    """The cache key of one stage call: its name, fn (a functools.partial
    by its function, arguments and keywords) and each argument, a tensor
    by its shape, dtype and device and anything else by its type and
    value."""
    return (name, _fn_key(fn), tuple(_arg_key(a) for a in args))


class _Bound:
    """fn with a call's other arguments in place: called with the call's
    tensors in order, it calls fn with each tensor argument replaced.  It
    keeps no tensor of the call it was made from."""

    def __init__(self, name, fn, args):
        self.__name__ = name
        self.fn = fn
        self.where = [i for i, a in enumerate(args)
                      if isinstance(a, torch.Tensor)]
        self.args = [None if isinstance(a, torch.Tensor) else a for a in args]

    def __call__(self, *tensors):
        args = list(self.args)
        for i, t in zip(self.where, tensors):
            args[i] = t
        return self.fn(*args)


def slot_keys(tensors) -> list:
    """The static input slots of a call's tensors: the k-th tensor of one
    shape, dtype and device takes slot k of that kind."""
    seen = collections.Counter()
    keys = []
    for t in tensors:
        kind = (tuple(t.shape), t.dtype, t.device)
        keys.append(kind + (seen[kind],))
        seen[kind] += 1
    return keys


class StageGraphs:
    """The stage graphs of a process, by stage signature (the module's
    docstring); `call` runs one stage and may record two events right
    around its replay."""

    def __init__(self):
        self.graphs = {}          # stage_key -> CapturedFrame
        self.slots = {}           # slot_keys entry -> static input buffer
        self.pools = {}           # device -> the pool its graphs share
        self.done = {}            # device -> event after the last clones
        self._lock = threading.Lock()

    def call(self, name: str, fn, args, start=None, end=None):
        """fn(*args) as stage `name`; on CUDA tensors its graph's replay,
        with `start` and `end` (CUDA events) recorded on the current stream
        just before and just after it: the copies into the static inputs
        and the clones of the outputs fall outside them."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or not tensors[0].is_cuda:
            return fn(*args)
        dev = tensors[0].device
        if any(t.device != dev for t in tensors):
            raise ValueError(f"stage {name}: tensors on "
                             f"{sorted({str(t.device) for t in tensors})}")
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"stage {name}: a stage graph cannot be "
                               f"captured inside another capture")
        key = stage_key(name, fn, args)
        with self._lock, torch.cuda.device(dev):
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.first_call(name, fn, args, tensors, dev)
                self.graphs[key] = graph
            graph.load(tensors)
            stream = torch.cuda.current_stream()
            if start is not None:
                start.record(stream)
            graph.replay()
            if end is not None:
                end.record(stream)
            return graph.result()

    def first_call(self, name, fn, args, tensors, dev) -> CapturedFrame:
        """Warm up on the caller's tensors, make room, capture into the
        device's shared pool on the slots, and hand the outputs' memory
        back to the pool (the module's docstring)."""
        bound = _Bound(name, fn, args)
        while True:
            try:
                warm = warm_up(bound, tensors, (), dev)
                break
            except torch.cuda.OutOfMemoryError:
                if not self.free_memory():
                    raise
        keys = slot_keys(tensors)
        self.make_room(capture_need(warm) + nbytes(tuple(
            t for t, k in zip(tensors, keys) if k not in self.slots)), dev)
        for k in keys:
            if k not in self.slots:
                self.slots[k] = torch.empty(k[0], dtype=k[1], device=k[2])
        inputs = [self.slots[k] for k in keys]
        if dev not in self.pools:
            self.pools[dev] = torch.cuda.graph_pool_handle()
            self.done[dev] = torch.cuda.Event()
        graph = capture(bound, inputs, (), dev, warm, self.pools[dev])
        graph.output = map_tensors(borrowed, graph.output)
        graph.done = self.done[dev]
        return graph

    def free_memory(self) -> bool:
        """Evict the oldest captured frame, or else every stage graph;
        False when there is nothing left to free."""
        with CACHE._lock:
            if CACHE.frames:
                CACHE.evict_oldest()
                return True
        if not self.graphs:
            return False
        self.clear()
        return True

    def make_room(self, need: int, device) -> None:
        """Release cached blocks, then free (free_memory) while the card
        has less than `need` bytes free."""
        torch.cuda.empty_cache()
        while torch.cuda.mem_get_info(device)[0] < need and self.free_memory():
            pass

    def clear(self) -> None:
        """Drop every stage graph, the slots and the pools."""
        if self.graphs or self.slots:
            self.graphs.clear()
            self.slots.clear()
            self.pools.clear()
            self.done.clear()
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        """The graphs held, their warm-ups' and captures' seconds, their
        pools' bytes and the slots' bytes."""
        st = [g.stats for g in self.graphs.values()]
        return {"graphs": len(st),
                "warmup_s": sum(s["warmup_s"] for s in st),
                "capture_s": sum(s["capture_s"] for s in st),
                "pool_bytes": sum(s["pool_bytes"] for s in st),
                "input_bytes": nbytes(tuple(self.slots.values()))}


STAGES = StageGraphs()


def replay_stage(name: str, fn, *args):
    """The replaying stage runner: fn(*args) through the process's stage
    graphs (STAGES)."""
    return STAGES.call(name, fn, args)


def clear_caches() -> None:
    """Drop every captured frame and stage graph and release their pools."""
    CACHE.clear()
    STAGES.clear()
