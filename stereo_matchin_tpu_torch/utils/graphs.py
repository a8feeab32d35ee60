"""Whole frames captured as CUDA graphs: the port's counterpart of
`jax.jit` over the JAX package's frame entries (`asw_pipeline`,
`cross_pipeline`, `asw_pipeline_batched`).

`replay(fn, tensors, statics)` computes `fn(*tensors, *statics)`:

  * on CPU tensors it calls fn, with no `torch.cuda` call at all;
  * on CUDA tensors it replays the graph of the call's `signature` (fn,
    each tensor's shape, dtype and device, and the hashable static
    arguments: a frozen StereoConfig, a crop), as XLA traces once per
    signature and then runs the executable.  The first call of a
    signature runs fn once on the caller's tensors (the warm-up: it builds
    and loads the kernels and measures the frame's peak), copies the
    tensors into static buffers of its own and captures fn on them.  Every
    call copies the caller's tensors into the static buffers, replays on
    the current stream and returns a new result of fn's NamedTuple type
    with every field cloned: a result the caller holds is never
    overwritten by a later call, as each call of a jitted function returns
    fresh arrays.

Only the shapes and the static arguments may steer fn from the host: a
value fn read from a tensor while it was captured would be frozen into
the graph.  A capture that fails raises; nothing runs the eager frame in
its place (the eager chains keep their JAX names, `*_impl`).

Launch counts stay true.  The kernel wrappers count `kernels.LAUNCHES` in
Python, which a replay does not run: the capture's count is kept as one
frame's and added once per replay, and the counters are put back as they
were before the warm-up and the capture.  So every call, the first one
included, counts exactly one frame.

Memory, as XLA's allocator lends every compiled program the same buffers:

  * the frames of a device share one memory pool (a torch.cuda.MemPool),
    apart from the stage graphs' pools below, so that each family is freed
    as a unit.  A frame's outputs go back to the pool once it is captured
    and are read through views that do not own their memory (`borrowed`);
    each call clones them before the next replay of any frame writes the
    pool, so the frames may replay in any order and the pool holds about
    the largest frame's peak, whatever the count of signatures;
  * the cache keeps every signature while memory allows; there is no count
    cap.  A first call warms fn up inside the pool it then captures into,
    on the stream it captures on (the caching allocator hands a freed block
    only to its own stream): the blocks the warm-up frees are the blocks
    the capture takes, and no second frame's worth lies beside the pool;
  * after the warm-up, while the card has fewer free bytes than the
    capture needs (`capture_need`: the warm-up's peak and POOL_MARGIN of
    it, above the bytes free in the pool, and the first replay's clones)
    and the new static inputs, `free_memory` drops every captured frame
    (one frame cannot hand its part of a shared pool back), then every
    stage graph unless a hold holds one.  A warm-up that runs out of
    memory frees the same way and runs again.

The first call of a signature resets the card's peak-memory statistic
(the warm-up's peak is measured from it).  `clear_caches()` drops every
graph, as `jax.clear_caches` drops the compiled programs.

Calls may come from different streams: each call waits for the previous
call's replay and clones, of any graph of its family on its device, before
it overwrites the static inputs; a first call waits for the whole card.

Spans and counters (`utils/profiling.py`): while a torch.profiler session
records, each call of `replay` on CUDA tensors leaves an `entry` span and
its `entry.launch` child (the graph's replay); while none records, the
call reads one flag.  The frame cache counts, whatever records, its first
calls and their seconds of warm-up, making room and capture (the timers
of `CapturedFrame.stats`), and the high-water mark of its pools' and
static inputs' bytes, read after each capture and before `free_memory`
drops the frames (`profiling.COUNTERS`).

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
call warms fn up on the caller's own tensors inside the pool every stage
graph of a device shares, makes room as a frame does, captures fn into
that pool, and replays it; every call returns clones (`clone_result`:
tensors, tuples and NamedTuples, nested, each of its own type).

A frame runs tens of stages, so stage graphs also share their static
inputs: the k-th tensor of one shape, dtype and device in a call takes
the k-th slot of that kind, one buffer for every graph (the calls are
ordered by one event, as a frame's are).  The stage runner never runs
inside a capture: the eager chains (`asw_pipeline_impl`,
`cross_pipeline_impl`) keep `utils.call_stage` as their runner, since the
frame entries capture them whole.

The band drivers (models/tiled.py, models/wavefront.py,
models/wavefront_cross.py) run each band as one stage through the same
runner, keyed by the band's canonical geometry, so the interior bands of
a frame share one graph: the port's counterpart of the JAX package's
band-step jits.  Their memory rule:

  * a driver's band graphs share the stage graphs' pool, so a captured
    banded frame holds about its largest band's peak, not the sum of its
    bands' peaks, and a band's first call warms up in that pool;
  * the strips a band hands the next pass through the static input slots
    (the port's form of the JAX donation): one slot per strip, whatever
    band reads it;
  * a frame holds its own graphs (`StageGraphs.hold`): while it runs,
    making room and a warm-up out of memory drop captured frames, never
    the stage graphs, since they share the pool with the graphs the frame
    already captured; with nothing left to drop a first call raises.  A
    frame whose bands outgrow the card fails on its first call, instead
    of capturing every band again on every frame.

The sharded pipelines (parallel/asw_sharded.py, parallel/cross_sharded.py,
parallel/wta_sharded.py) run each compute segment between two collectives
as one step through the same runner, keyed by the shard's offsets, while
the collectives stay eager between the steps (under gloo they move
through host memory, which a capture cannot hold): the port's counterpart
of the JAX package's jit over shard_map.  A frame holds its graphs, as a
banded frame does.  Their weights, denominators and volume cross many
steps, and a rank shares the card with the other ranks, so a copy of each
in a clone and another in a slot would not fit (PERF.md, PR 16).  So a
step marked `resident` keeps its outputs where its graph wrote them:

  * on the card each call returns the graph's own output tensors, not
    clones; the step's next replay overwrites them, so a caller uses them
    only before it calls that step again (a sharded frame's weights, its
    aggregation rounds' volume), and never returns them;
  * they stay allocated while the graph lives, in a second pool of the
    device that only resident steps share (their warm-ups run there too).
    A capture may take any memory that is free at that moment, so in the
    shared pool a resident step's outputs could lie where a graph captured
    before it keeps its temporaries or outputs, and that graph's next
    replay would overwrite them (it did: a config-3 sharded frame's
    refinement strips, captured after the first WTA's steps, whose graphs
    run again in every refinement round).  Among resident steps the same
    holds, so a frame calls them in the order of their first capture and
    uses a resident output only until a resident step captured before it
    runs again (a sharded frame: weights, rounds, pin, refinement strips;
    the next frame computes them anew);
  * a later step that takes one of them reads it where it is: no slot and
    no copy, its address part of that step's key (stable, since the
    resident graph writes the same memory on every replay).

A stage's arguments may not nest a tensor in a tuple, list or dict: its
key would hold the tensor's identity and its graph would read the tensor
from where it was captured (`stage_key` refuses it).  Its result may nest
tensors in tuples, NamedTuples and dicts; each is cloned, unless the
step is resident.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

from .. import kernels
from . import profiling

# A pool's bytes above its warm-up's peak: 4-17% on the card (PERF.md,
# section 5), so a quarter.
POOL_MARGIN = 0.25

# First calls, replays and freeing, one at a time: freeing crosses the
# families.
_LOCK = threading.RLock()


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
    """`out` with fn applied to each tensor in it: a tensor, or tuples,
    lists and dicts of them (NamedTuples and dict types kept), nested;
    anything else is returned as it is."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(map_tensors(fn, v) for v in out))
    if isinstance(out, (tuple, list)):
        return type(out)(map_tensors(fn, v) for v in out)
    if isinstance(out, dict):
        return type(out)((k, map_tensors(fn, v)) for k, v in out.items())
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


def pool_state(pool) -> tuple:
    """(reserved, free) bytes of a torch.cuda.MemPool, (0, 0) for None: its
    segments' bytes, and those of them no tensor holds."""
    if pool is None:
        return 0, 0
    segments = [s for s in torch.cuda.memory_snapshot(pool.id)
                if tuple(s["segment_pool_id"]) == tuple(pool.id)]
    reserved = sum(s["total_size"] for s in segments)
    return reserved, reserved - sum(s["allocated_size"] for s in segments)


def capture_need(warm: dict, pool_free: int = 0) -> int:
    """The free bytes a capture needs: what its pool needs (the warm-up's
    peak and POOL_MARGIN of it) above the `pool_free` bytes free in it, and
    the first replay's clones."""
    peak = warm["warmup_peak_bytes"]
    return (max(0, peak + int(peak * POOL_MARGIN) - pool_free)
            + warm["output_bytes"])


class CapturedFrame:
    """One signature's graph, its static input and output tensors, the
    launches of one frame, what its first call measured (seconds of
    warm-up, of making room and of capture, the warm-up's peak bytes, the
    result's bytes),
    and `done`, its family's event after the last call's clones on its
    device."""

    def __init__(self, graph, inputs, output, launches, stats):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.launches, self.stats = launches, stats
        self.done = None

    def load(self, tensors) -> None:
        """Wait for the last call's clones, then copy the call's tensors
        into the static inputs; an input the graph reads in place (a
        resident step's output) is not copied."""
        torch.cuda.current_stream().wait_event(self.done)
        for buf, t in zip(self.inputs, tensors):
            if buf.data_ptr() != t.data_ptr():
                buf.copy_(t)

    def replay(self, timeline=None) -> None:
        """The graph's replay, a `launch` child span of `timeline` (a
        profiling.Timeline, or None while no profiler records), then its
        launches counted."""
        if timeline is None:
            self.graph.replay()
        else:
            start = time.perf_counter_ns()
            self.graph.replay()
            timeline.child("launch", start)
        add_launches(kernels.LAUNCHES, self.launches)

    def result(self):
        """Clones of the outputs (clone_result); the next call waits for
        them."""
        out = clone_result(self.output)
        self.done.record(torch.cuda.current_stream())
        return out

    def __call__(self, tensors, timeline=None):
        self.load(tensors)
        self.replay(timeline)
        return self.result()


def warm_up(fn, inputs, statics, dev, pool, stream) -> dict:
    """Run fn once on `stream`, its memory in `pool` (a torch.cuda.MemPool),
    after all work on `dev`: it builds and loads the kernels, and leaves
    the blocks it freed in the pool, where a capture on the same stream
    takes them again.  Returns its seconds, its peak bytes above those
    allocated before it, the bytes of its result (which it drops) and its
    launches; the launch counters are put back."""
    before = dict(kernels.LAUNCHES)
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, dev):
            out = fn(*inputs, *statics)
            output_bytes = nbytes(out)
            del out
        torch.cuda.synchronize(dev)
        return {"warmup_s": time.perf_counter() - t0,
                "warmup_peak_bytes": torch.cuda.max_memory_allocated(dev)
                - base, "output_bytes": output_bytes,
                "launches": launch_delta(before, kernels.LAUNCHES)}
    finally:
        kernels.LAUNCHES.update(before)


def capture(fn, inputs, statics, dev, warm, pool, stream) -> CapturedFrame:
    """Capture fn on `inputs` into `pool` (a torch.cuda.MemPool) on
    `stream`, after warm_up; the launch counters are put back."""
    before = dict(kernels.LAUNCHES)
    try:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.id, stream=stream):
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
    return CapturedFrame(graph, inputs, output, launches,
                         stats | {"capture_s": capture_s})


def free_memory() -> bool:
    """Drop every captured frame, or else every stage graph unless a hold
    holds one of them; False when there is nothing left to free."""
    with _LOCK:
        if CACHE.graphs:
            CACHE.count_held()
            CACHE.clear()
            return True
        return STAGES.drop()


def make_room(need, device) -> None:
    """Release cached blocks, then free (free_memory) while the card has
    fewer than need() bytes free (need is asked again after each drop)."""
    torch.cuda.empty_cache()
    while torch.cuda.mem_get_info(device)[0] < need() and free_memory():
        pass


class GraphFamily:
    """Graphs of one kind by key, captured into their family's memory pools
    (one a device, and one more for resident steps): a family is freed as a
    unit, never one graph's part of a pool."""

    def __init__(self):
        self.graphs = {}          # key -> CapturedFrame
        self.pools = {}           # (device, resident) -> torch.cuda.MemPool
        self.streams = {}         # device -> its warm-ups' and captures'
        self.done = {}            # device -> event after the last clones

    def pool(self, dev, resident=False):
        if (dev, resident) not in self.pools:
            self.pools[dev, resident] = torch.cuda.MemPool()
        return self.pools[dev, resident]

    def stream(self, dev):
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        return self.streams[dev]

    def first_capture(self, fn, tensors, statics, dev, inputs, new_bytes,
                      resident=False) -> CapturedFrame:
        """Warm fn up on the caller's tensors inside the pool it captures
        into (a warm-up out of memory frees and runs again), make room for
        the capture and new_bytes() of new static inputs, then capture fn on
        inputs() (the module's docstring)."""
        while True:
            try:
                warm = warm_up(fn, tensors, statics, dev,
                               self.pool(dev, resident), self.stream(dev))
                break
            except torch.cuda.OutOfMemoryError:
                if not free_memory():
                    raise
        t0 = time.perf_counter()
        make_room(lambda: capture_need(warm, pool_state(
            self.pools.get((dev, resident)))[1]) + new_bytes(), dev)
        make_room_s = time.perf_counter() - t0
        graph = capture(fn, inputs(), statics, dev, warm,
                        self.pool(dev, resident), self.stream(dev))
        graph.stats["make_room_s"] = make_room_s
        if dev not in self.done:
            self.done[dev] = torch.cuda.Event()
        graph.done = self.done[dev]
        return graph

    def input_tensors(self) -> list:
        return [t for g in self.graphs.values() for t in g.inputs]

    def clear(self) -> None:
        """Drop every graph, then the pools."""
        if self.graphs or self.pools:
            self.graphs.clear()
            self.pools.clear()
            self.done.clear()
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        """The graphs held, their warm-ups' and captures' seconds, the
        family's pools' bytes and its static inputs' bytes."""
        st = [g.stats for g in self.graphs.values()]
        return {"graphs": len(st),
                "warmup_s": sum(s["warmup_s"] for s in st),
                "capture_s": sum(s["capture_s"] for s in st),
                "pool_bytes": sum(pool_state(p)[0]
                                  for p in self.pools.values()),
                "input_bytes": nbytes(self.input_tensors())}


class GraphCache(GraphFamily):
    """The captured frames by signature (the module's docstring)."""

    def first_call(self, fn, tensors, statics, dev) -> CapturedFrame:
        """Warm up, make room, capture into the device's frame pool on
        copies of the call's tensors (this signature's static inputs,
        outside the pool), and hand the outputs' memory back to the
        pool."""
        graph = self.first_capture(
            fn, tensors, statics, dev,
            inputs=lambda: tuple(t.clone() for t in tensors),
            new_bytes=lambda: nbytes(tensors))
        graph.output = map_tensors(borrowed, graph.output)
        return graph

    def count_held(self) -> None:
        """Raise the cache's high-water mark (profiling.COUNTERS) to the
        bytes it holds: its pools' and its static inputs'."""
        st = self.stats()
        profiling.COUNTERS["frames"].held(st["pool_bytes"]
                                          + st["input_bytes"])

    def __call__(self, fn, tensors, statics):
        if not any(t.is_cuda for t in tensors):
            return fn(*tensors, *statics)
        timeline = profiling.SPANS.open("entry")
        key = signature(fn, tensors, statics)
        dev = next(t.device for t in tensors if t.is_cuda)
        with _LOCK, torch.cuda.device(dev):
            frame = self.graphs.get(key)
            if frame is None:
                frame = self.first_call(fn, tensors, statics, dev)
                self.graphs[key] = frame
                profiling.COUNTERS["frames"].first_call(frame.stats)
                self.count_held()
            out = frame(tensors, timeline)
        if timeline is not None:
            timeline.close()
        return out


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


def _nests_tensor(a) -> bool:
    if isinstance(a, torch.Tensor):
        return True
    if isinstance(a, (tuple, list, set, frozenset)):
        return any(_nests_tensor(v) for v in a)
    if isinstance(a, dict):
        return any(_nests_tensor(v) for v in (*a.keys(), *a.values()))
    return False


def check_args(name: str, args) -> None:
    """Refuse a stage argument that nests a tensor in a container."""
    for i, a in enumerate(args):
        if not isinstance(a, torch.Tensor) and _nests_tensor(a):
            raise ValueError(
                f"stage {name}: argument {i} ({type(a).__name__}) nests a "
                f"tensor, which its graph would read from where it was "
                f"captured; pass each tensor as an argument of its own")


def stage_key(name: str, fn, args) -> tuple:
    """The cache key of one stage call: its name, fn (a functools.partial
    by its function, arguments and keywords) and each argument, a tensor
    by its shape, dtype and device and anything else by its type and
    value.  An argument that nests a tensor in a container is refused."""
    check_args(name, args)
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


def resident(fn):
    """Mark fn as a resident step (the module's docstring): on the card its
    calls return its graph's own outputs, which later steps read in place.
    Returns fn."""
    fn.stage_resident = True
    return fn


def is_resident(fn) -> bool:
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "stage_resident", False)


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


class StageGraphs(GraphFamily):
    """The stage graphs of a process, by stage signature (the module's
    docstring); `call` runs one stage and may record two events right
    around its replay."""

    def __init__(self):
        super().__init__()
        self.slots = {}           # slot_keys entry -> static input buffer
        self.resident = set()     # storages of resident steps' outputs
        self._holds = 0           # open hold() contexts
        self._held = set()        # stage keys called inside them

    @contextlib.contextmanager
    def hold(self):
        """Within it, the stage graphs called are held: free_memory never
        drops them (a band driver's frame; the module's docstring).  It
        touches no `torch.cuda`."""
        self._holds += 1
        try:
            yield
        finally:
            self._holds -= 1
            if not self._holds:
                self._held.clear()

    def call(self, name: str, fn, args, start=None, end=None):
        """fn(*args) as stage `name`; on CUDA tensors its graph's replay,
        with `start` and `end` (CUDA events) recorded on the current stream
        just before and just after it: the copies into the static inputs
        and the clones of the outputs fall outside them.  An argument that
        nests a tensor is refused on every device (check_args)."""
        check_args(name, args)
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
        with _LOCK, torch.cuda.device(dev):
            in_place = self.in_place(tensors)
            key += tuple((i, t.data_ptr(), t.stride())
                         for i, (t, r) in enumerate(zip(tensors, in_place))
                         if r)
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.first_call(name, fn, args, tensors, dev,
                                        in_place)
                self.graphs[key] = graph
            if self._holds:
                self._held.add(key)
            graph.load(tensors)
            stream = torch.cuda.current_stream()
            if start is not None:
                start.record(stream)
            graph.replay()
            if end is not None:
                end.record(stream)
            if is_resident(fn):
                graph.done.record(stream)
                return graph.output
            return graph.result()

    def in_place(self, tensors) -> list:
        """For each tensor, whether it is a resident step's output, which a
        graph reads where it is."""
        return [t.untyped_storage().data_ptr() in self.resident
                for t in tensors]

    def first_call(self, name, fn, args, tensors, dev,
                   in_place=None) -> CapturedFrame:
        """Warm up on the caller's tensors and capture into the device's
        shared pool on the slots (a resident step's output in place), and
        hand the outputs' memory back to the pool; a resident step warms up
        and captures in the device's pool of resident steps and keeps its
        outputs (the module's docstring)."""
        in_place = in_place or [False] * len(tensors)
        resident = is_resident(fn)
        copied = [t for t, r in zip(tensors, in_place) if not r]
        keys = slot_keys(copied)

        def inputs():
            for k in keys:
                if k not in self.slots:
                    self.slots[k] = torch.empty(k[0], dtype=k[1], device=k[2])
            slots = iter([self.slots[k] for k in keys])
            return [t if r else next(slots) for t, r in zip(tensors, in_place)]

        graph = self.first_capture(
            _Bound(name, fn, args), tensors, (), dev, inputs,
            lambda: nbytes(tuple(t for t, k in zip(copied, keys)
                                 if k not in self.slots)), resident)
        if resident:
            outs = {t.untyped_storage().data_ptr()
                    for t in leaves(graph.output)}
            if outs & {s.untyped_storage().data_ptr()
                       for s in self.slots.values()}:
                raise ValueError(f"resident step {name} returns an input "
                                 f"it was given in a slot, which other "
                                 f"steps overwrite")
            self.resident |= outs
        else:
            graph.output = map_tensors(borrowed, graph.output)
        return graph

    def drop(self) -> bool:
        """Drop every stage graph unless a hold holds one of them; False
        when there is none or one is held."""
        if not self.graphs or not self._held.isdisjoint(self.graphs):
            return False
        self.clear()
        return True

    def input_tensors(self) -> list:
        return list(self.slots.values())

    def clear(self) -> None:
        """Drop every stage graph, the slots (made only after a pool) and
        the pools."""
        self.slots.clear()
        self.resident.clear()
        super().clear()


STAGES = StageGraphs()


def replay_stage(name: str, fn, *args):
    """The replaying stage runner: fn(*args) through the process's stage
    graphs (STAGES)."""
    return STAGES.call(name, fn, args)


def clear_caches() -> None:
    """Drop every captured frame and stage graph and release their pools."""
    with _LOCK:
        CACHE.clear()
        STAGES.clear()
