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

The band drivers (models/tiled.py, models/wavefront.py,
models/wavefront_cross.py) run each band as one stage through the same
runner, keyed by the band's canonical geometry, so the interior bands of
a frame share one graph: the port's counterpart of the JAX package's
band-step jits.  Their memory rule:

  * a driver's band graphs share the stage graphs' pool, so a captured
    banded frame holds about its largest band's peak, not the sum of its
    bands' peaks;
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
    device that only resident steps share.  A capture may take any memory
    that is free at that moment, so in the shared pool a resident step's
    outputs could lie where a graph captured before it keeps its
    temporaries or outputs, and that graph's next replay would overwrite
    them (it did: a config-3 sharded frame's refinement strips, captured
    after the first WTA's steps, whose graphs run again in every
    refinement round).  Among resident steps the same holds, so a frame
    calls them in the order of their first capture and uses a resident
    output only until a resident step captured before it runs again (a
    sharded frame: weights, rounds, pin, refinement strips; the next frame
    computes them anew);
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
        into the static inputs; an input the graph reads in place (a
        resident step's output) is not copied."""
        torch.cuda.current_stream().wait_event(self.done)
        for buf, t in zip(self.inputs, tensors):
            if buf.data_ptr() != t.data_ptr():
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


class StageGraphs:
    """The stage graphs of a process, by stage signature (the module's
    docstring); `call` runs one stage and may record two events right
    around its replay."""

    def __init__(self):
        self.graphs = {}          # stage_key -> CapturedFrame
        self.slots = {}           # slot_keys entry -> static input buffer
        self.pools = {}           # (device, resident) -> the pool those
                                  # graphs share
        self.done = {}            # device -> event after the last clones
        self.resident = set()     # storages of resident steps' outputs
        self._lock = threading.Lock()
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
        with self._lock, torch.cuda.device(dev):
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
        """Warm up on the caller's tensors, make room, capture into the
        device's shared pool on the slots (a resident step's output in
        place), and hand the outputs' memory back to the pool; a resident
        step captures into the device's pool of resident steps and keeps
        its outputs (the module's docstring)."""
        in_place = in_place or [False] * len(tensors)
        bound = _Bound(name, fn, args)
        while True:
            try:
                warm = warm_up(bound, tensors, (), dev)
                break
            except torch.cuda.OutOfMemoryError:
                if not self.free_memory():
                    raise
        copied = [t for t, r in zip(tensors, in_place) if not r]
        keys = slot_keys(copied)
        self.make_room(capture_need(warm) + nbytes(tuple(
            t for t, k in zip(copied, keys) if k not in self.slots)), dev)
        for k in keys:
            if k not in self.slots:
                self.slots[k] = torch.empty(k[0], dtype=k[1], device=k[2])
        slots = iter([self.slots[k] for k in keys])
        inputs = [t if r else next(slots) for t, r in zip(tensors, in_place)]
        resident = is_resident(fn)
        if (dev, resident) not in self.pools:
            self.pools[dev, resident] = torch.cuda.graph_pool_handle()
        if dev not in self.done:
            self.done[dev] = torch.cuda.Event()
        graph = capture(bound, inputs, (), dev, warm,
                        self.pools[dev, resident])
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
        graph.done = self.done[dev]
        return graph

    def free_memory(self) -> bool:
        """Evict the oldest captured frame, or else every stage graph
        unless a hold holds one of them; False when there is nothing left
        to free."""
        with CACHE._lock:
            if CACHE.frames:
                CACHE.evict_oldest()
                return True
        if not self.graphs or not self._held.isdisjoint(self.graphs):
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
            self.resident.clear()
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
