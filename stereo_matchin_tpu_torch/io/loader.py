"""Threaded prefetching stereo-pair loader (the port's own copy of the JAX
engine's `runtime/loader.py`).

The reference decodes PNGs synchronously on the host thread and uploads
with blocking CL_MEM_COPY_HOST_PTR creates (main.cpp:184-186,243-244),
serialising I/O against compute.  This loader decodes the next pairs on a
worker thread (PIL, through `io.png.read_rgb`, which releases the
interpreter lock while it decodes) while the caller computes on the
current one.  It yields host arrays; the caller copies them to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence, Tuple

from . import png

# Decoded pairs buffered ahead of the consumer.
DEPTH = 2
# How long a closed iterator waits for its worker to finish the pair it is
# decoding, and how often a worker blocked on a full queue looks for `stop`.
JOIN_TIMEOUT_S = 30.0
_POLL_S = 0.05


class PairLoader:
    """Iterate (left, right) (H, W, 3) float32 numpy images, decoded DEPTH
    pairs ahead on a worker thread.

    pairs: sequence of (left_path, right_path).
    """

    _SENTINEL = object()

    def __init__(self, pairs: Sequence[Tuple[str, str]]):
        self._pairs = list(pairs)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
        stop = threading.Event()

        def put(item) -> bool:
            # A blocking put would hold the worker forever once the consumer
            # has gone; poll so that a closed iterator always ends it.
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            # A worker exception (corrupt/missing file) must surface in the
            # consumer, not silently truncate the stream: ship it through
            # the queue and re-raise on the iterating thread.
            error = None
            try:
                for lp, rp in self._pairs:
                    if stop.is_set() or not put((png.read_rgb(lp),
                                                 png.read_rgb(rp))):
                        return
            except BaseException as exc:  # noqa: BLE001 — forwarded
                error = exc
            finally:
                put((self._SENTINEL, error))

        t = threading.Thread(target=worker, name="PairLoader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item[0] is self._SENTINEL:
                    if item[1] is not None:
                        raise item[1]
                    break
                yield item
        finally:
            stop.set()
            # Drop what the worker decoded ahead; a worker blocked on the
            # full queue sees `stop` at its next poll.
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(JOIN_TIMEOUT_S)

    def __len__(self) -> int:
        return len(self._pairs)
