"""Background-thread prefetching for host-side input work.

Counterpart of the JAX package's data/prefetch.py.  The training input path
does real host work per batch (image decode, augmentation, the preprocess
call on the card, greedy packing, padded-batch assembly).  `prefetch`
drains the source iterator on a background thread into a bounded queue so
host work for batch i+1 overlaps device execution of batch i.

The worker thread launches the DCT kernel (kernels/dct_patchify.py) and
copies the packed batch to the card.  Both go on the stream that
``torch.cuda.current_stream()`` returns in the worker: the legacy default
stream, the same one the training step uses on the main thread, unless a
caller sets another.  So the step's kernels are queued after the copies of
its batch, and the batch needs no event or stream wait.  (The extractor also
reads its tokens back to the host, which synchronizes, before packing.)

Shutdown is cooperative: when the consumer stops early (max_iters break),
the generator's finally sets a stop event, drains the queue so a blocked
put() releases, and joins the worker, so that no thread is left inside a
device call when the interpreter exits.

Spans (obs.py): each `next(source)` of the worker is `dct.prefetch.produce`,
on the thread named `batch-prefetch`, and the consumer's wait for an item is
`dct.prefetch.wait`.

Exceptions raised by the source propagate to the consumer at the point of
`next()`; a sentinel marks exhaustion.  `buffer_size` bounds host memory
(packed batches are a few MB each).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from .. import obs

T = TypeVar("T")

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(source: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Iterate `source` on a background thread, `buffer_size` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that aborts when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            items = iter(source)
            while True:
                with obs.span("dct.prefetch.produce"):
                    item = next(items, _DONE)
                if item is _DONE:
                    break
                if not _put(item):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            _put(_Failure(e))
            return
        _put(_DONE)

    t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
    t.start()

    try:
        while True:
            with obs.span("dct.prefetch.wait"):
                item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        # The worker is bounded by one in-flight item, which can be slow (a
        # first kernel build, a large image decode): join in slices and say so
        # while waiting, and register a final join at exit.
        deadline = 300.0
        waited = 0.0
        while t.is_alive() and waited < deadline:
            t.join(timeout=15.0)
            waited += 15.0
            if t.is_alive() and waited in (15.0, 60.0, 120.0, 240.0):
                print(f"[prefetch] waiting on worker shutdown ({waited:.0f}s: blocked in a slow source next())")
        if t.is_alive():
            print(
                f"[prefetch] WARNING: worker did not stop within {deadline:.0f}s; "
                "registering a final join at interpreter exit"
            )
            import atexit

            atexit.register(t.join, 60.0)
