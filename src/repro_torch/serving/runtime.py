"""Continuous-batching TM server: dispatch/result threads over the bucket
cache, bounded-backlog admission, per-tenant fairness.

Port of ``repro.serving.runtime``. The phases pipeline:

  * ``submit`` (any thread) — admission control first: past the backlog's
    row/byte budget the request resolves *immediately* with a typed
    ``Overloaded`` result; admitted requests enter their tenant's FIFO.
  * the **dispatch thread** — takes up to a top bucket of rows by weighted
    round-robin (``fairness.TenantQueues``), pads them into a host staging
    buffer and dispatches through the bucket cache. Dispatch does not wait
    for the device: the staging buffer is pinned on a CUDA session, so the
    copy to the card and the kernels are queued and the thread moves on to
    form batch N+1 while batch N computes. There is one staging buffer per
    in-flight slot, and a buffer returns to the pool only when its batch
    has completed, so no buffer is rewritten while its copy is in flight.
    An ``inflight`` slot semaphore applies backpressure before a batch is
    formed.
  * the **result thread** — waits for each in-flight batch in dispatch
    order (``.cpu()`` is where the host syncs with the device), completes
    the per-request promises with ``ScoreResult``, records per-tenant
    latency, releases the backlog budget, then frees the slot.

There is no batching timer: the in-flight device compute *is* the batching
window. Every phase is also callable synchronously (``step()``), so
admission, fairness and completion are unit-testable with a deterministic
clock and no threads.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.serving.aot import AOTBucketCache, bucket_for
from repro_torch.serving.fairness import TenantQueues, TenantStats


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """Successful completion: one request's class scores + timing."""

    scores: np.ndarray  # (n_classes,)
    tenant: str
    arrival_s: float
    done_s: float

    @property
    def latency_s(self) -> float:
        """Arrival→completion latency (queueing + padding + compute)."""
        return self.done_s - self.arrival_s


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed admission rejection: the backlog budget was exhausted."""

    tenant: str
    arrival_s: float
    backlog_rows: int
    backlog_bytes: int
    max_rows: int
    max_bytes: int


class Promise:
    """Single-assignment completion slot for one submitted request."""

    __slots__ = ("_event", "result")

    def __init__(self):
        self._event = threading.Event()
        self.result = None

    def resolve(self, result) -> None:
        """Deliver the ``ScoreResult`` / ``Overloaded`` / error (once)."""
        self.result = result
        self._event.set()

    @property
    def done(self) -> bool:
        """True once ``resolve`` ran."""
        return self._event.is_set()

    def wait(self, timeout: float | None = None):
        """Block until resolved; returns the result, raises the error the
        server hit while serving this request, or ``TimeoutError``."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if isinstance(self.result, BaseException):
            raise self.result
        return self.result


class Backlog:
    """Bounded row/byte admission budget over queued + in-flight rows."""

    def __init__(self, max_rows: int, max_bytes: int):
        if max_rows < 1 or max_bytes < 1:
            raise ValueError(
                f"backlog budget must be positive, got max_rows={max_rows} "
                f"max_bytes={max_bytes}")
        self.max_rows = max_rows
        self.max_bytes = max_bytes
        self.rows = 0
        self.bytes = 0
        self._lock = threading.Lock()

    def try_admit(self, rows: int, nbytes: int) -> bool:
        """Reserve budget; False (and no reservation) past either limit."""
        with self._lock:
            if self.rows + rows > self.max_rows:
                return False
            if self.bytes + nbytes > self.max_bytes:
                return False
            self.rows += rows
            self.bytes += nbytes
            return True

    def release(self, rows: int, nbytes: int) -> None:
        """Return budget reserved by a successful ``try_admit``."""
        with self._lock:
            self.rows -= rows
            self.bytes -= nbytes


class _Pending:
    __slots__ = ("x", "tenant", "arrival_s", "promise", "nbytes")

    def __init__(self, x, tenant, arrival_s, promise):
        self.x = x
        self.tenant = tenant
        self.arrival_s = arrival_s
        self.promise = promise
        self.nbytes = x.nbytes


@dataclasses.dataclass(frozen=True)
class _Inflight:
    device_scores: object
    requests: list
    bucket: int
    staging: torch.Tensor


class AsyncTMServer:
    """Continuous-batching TM scores server over one (session × bundle).

    >>> server = AsyncTMServer(session, bundle, engine="indexed",
    ...                        max_batch=32).start()
    >>> result = server.submit(x_row, tenant="acme").wait()
    >>> server.stop()

    ``clock`` is injectable for deterministic tests. ``session`` may be None
    when ``aot`` is given (then staging buffers are not pinned).
    """

    def __init__(self, session, bundle, *, engine: str = "indexed",
                 max_batch: int = 32, aot: AOTBucketCache | None = None,
                 backlog_rows: int | None = None,
                 backlog_bytes: int = 64 << 20,
                 tenant_weights: dict[str, int] | None = None,
                 inflight: int = 2, clock=time.perf_counter):
        if aot is None:
            aot = AOTBucketCache(session, bundle, engines=(engine,),
                                 max_batch=max_batch)
        self.session = session
        self.bundle = bundle
        self.aot = aot
        self.engine = engine
        self.sizes = list(aot.bucket_sizes)
        self.n_features = aot.n_features
        top = self.sizes[-1]
        slots = max(inflight, 1)
        self.backlog = Backlog(
            max_rows=backlog_rows if backlog_rows is not None
            else 32 * top * slots,
            max_bytes=backlog_bytes)
        self._clock = clock
        self._tenants = TenantQueues(weights=tenant_weights)
        self._stats: dict[str, TenantStats] = {}
        self._cond = threading.Condition()
        self._inflight: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(slots)
        # one host staging buffer per in-flight slot (pinned for the card)
        pin = session is not None and session.device.type == "cuda"
        self._staging: queue.SimpleQueue = queue.SimpleQueue()
        for _ in range(slots):
            self._staging.put(torch.zeros((top, self.n_features),
                                          dtype=torch.uint8, pin_memory=pin))
        self._stopping = False
        self._threads: list[threading.Thread] = []
        # dispatch-side counters (single writer: the dispatch thread)
        self.batches = 0
        self.rows_real = 0
        self.rows_padded = 0
        self.completed = 0

    # -- request side -------------------------------------------------------

    def submit(self, x_row, tenant: str = "default") -> Promise:
        """Admit one ``(n_features,)`` uint8 request row.

        Returns a promise resolving to ``ScoreResult`` — or, when the
        backlog budget is exhausted, one already resolved to ``Overloaded``.
        """
        x_row = np.ascontiguousarray(x_row, np.uint8)
        promise = Promise()
        arrival = self._clock()
        with self._cond:
            stats = self._stats.get(tenant)
            if stats is None:
                stats = self._stats[tenant] = TenantStats()
            if not self.backlog.try_admit(1, x_row.nbytes):
                stats.rejected += 1
                promise.resolve(Overloaded(
                    tenant=tenant, arrival_s=arrival,
                    backlog_rows=self.backlog.rows,
                    backlog_bytes=self.backlog.bytes,
                    max_rows=self.backlog.max_rows,
                    max_bytes=self.backlog.max_bytes))
                return promise
            stats.admitted += 1
            self._tenants.push(
                tenant, _Pending(x_row, tenant, arrival, promise))
            self._cond.notify()
        return promise

    # -- engine (each phase callable synchronously for tests) ---------------

    def form_batch(self) -> list:
        """Take up to a top bucket of pending rows (weighted round-robin)."""
        with self._cond:
            return self._tenants.take(self.sizes[-1])

    def dispatch(self, reqs: list) -> _Inflight:
        """Pad one request list to its bucket in a staging buffer and
        dispatch through the bucket cache; never waits for the device."""
        k = len(reqs)
        b = bucket_for(k, self.sizes)
        try:
            staging = self._staging.get_nowait()
        except queue.Empty:
            raise RuntimeError(
                "more batches dispatched than in-flight slots: complete() "
                "one before dispatching another") from None
        try:
            host = staging.numpy()
            for i, r in enumerate(reqs):
                host[i] = r.x
            host[k:b] = 0
            dev = self.aot(staging[:b], engine=self.engine, bucket=b)
        except BaseException:
            self._staging.put(staging)
            raise
        self.batches += 1
        self.rows_real += k
        self.rows_padded += b
        return _Inflight(device_scores=dev, requests=reqs, bucket=b,
                         staging=staging)

    def complete(self, item: _Inflight) -> None:
        """Wait for one in-flight batch, resolve its promises, release the
        backlog budget and the staging buffer."""
        try:
            scores = item.device_scores
            host = (scores.cpu().numpy() if isinstance(scores, torch.Tensor)
                    else np.asarray(scores))  # the device sync happens here
        finally:
            self._staging.put(item.staging)
        done = self._clock()
        nbytes = 0
        with self._cond:
            for i, r in enumerate(item.requests):
                r.promise.resolve(ScoreResult(
                    scores=host[i], tenant=r.tenant,
                    arrival_s=r.arrival_s, done_s=done))
                self._stats[r.tenant].record(done - r.arrival_s)
                nbytes += r.nbytes
            self.completed += len(item.requests)
        self.backlog.release(len(item.requests), nbytes)

    def _fail(self, reqs: list, err: BaseException) -> None:
        """Resolve a batch that could not be served with the error, so
        callers see it instead of waiting forever."""
        for r in reqs:
            r.promise.resolve(err)
        self.backlog.release(len(reqs), sum(r.nbytes for r in reqs))

    def step(self) -> int:
        """One synchronous dispatch+complete round (unit tests; also a
        valid single-threaded serving mode). Returns rows served."""
        reqs = self.form_batch()
        if not reqs:
            return 0
        self.complete(self.dispatch(reqs))
        return len(reqs)

    # -- threads ------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            # backpressure before batch formation: each freed slot's take()
            # sees everything that arrived during the completed window
            self._slots.acquire()
            with self._cond:
                while not self._stopping and not len(self._tenants):
                    self._cond.wait()
                if self._stopping and not len(self._tenants):
                    self._slots.release()
                    break
                reqs = self._tenants.take(self.sizes[-1])
            if not reqs:
                self._slots.release()
                continue
            try:
                self._inflight.put(self.dispatch(reqs))
            except Exception as e:  # noqa: BLE001 — reported on the promises
                self._fail(reqs, e)
                self._slots.release()
        self._inflight.put(None)  # sentinel: drains then stops the results

    def _result_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                break
            try:
                self.complete(item)
            except Exception as e:  # noqa: BLE001 — reported on the promises
                self._fail(item.requests, e)
            self._slots.release()

    def start(self) -> "AsyncTMServer":
        """Spawn the dispatch and result threads (idempotent)."""
        if self._threads:
            return self
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name="tm-serve-dispatch", daemon=True),
            threading.Thread(target=self._result_loop,
                             name="tm-serve-result", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every admitted request has completed."""
        deadline = time.monotonic() + timeout
        while self.backlog.rows > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.backlog.rows} rows still in flight after "
                    f"{timeout}s")
            time.sleep(0.001)

    def stop(self) -> None:
        """Serve out the remaining backlog, then join the threads."""
        if not self._threads:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        """Cumulative counters + per-tenant ledgers + cache counters."""
        with self._cond:
            per_tenant = {t: s.summary() for t, s in self._stats.items()}
            batches, rows_real = self.batches, self.rows_real
            rows_padded, completed = self.rows_padded, self.completed
        return {
            "batches": batches,
            "rows_real": rows_real,
            "rows_padded": rows_padded,
            "completed": completed,
            "backlog_rows": self.backlog.rows,
            "tenants": per_tenant,
            "aot": self.aot.counters(),
        }


class SyncTMServer(AsyncTMServer):
    """The synchronous drain loop behind the same submit surface — the
    baseline the async server is measured against.

    One worker thread serialises every phase: take a batch → pad → dispatch
    → wait for the device → complete → repeat. Same admission control,
    fairness, promises and bucket cache as ``AsyncTMServer``; the only
    difference is that dispatch and compute never overlap (one slot).
    """

    def __init__(self, session, bundle, *, engine: str = "indexed",
                 max_batch: int = 32, aot: AOTBucketCache | None = None,
                 backlog_rows: int | None = None,
                 backlog_bytes: int = 64 << 20,
                 tenant_weights: dict[str, int] | None = None,
                 clock=time.perf_counter):
        super().__init__(
            session, bundle, engine=engine, max_batch=max_batch, aot=aot,
            backlog_rows=backlog_rows, backlog_bytes=backlog_bytes,
            tenant_weights=tenant_weights, inflight=1, clock=clock)

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and not len(self._tenants):
                    self._cond.wait()
                if self._stopping and not len(self._tenants):
                    return
                reqs = self._tenants.take(self.sizes[-1])
            if not reqs:
                continue
            try:
                self.complete(self.dispatch(reqs))
            except Exception as e:  # noqa: BLE001 — reported on the promises
                self._fail(reqs, e)

    def start(self) -> "SyncTMServer":
        """Spawn the single blocking serve thread (idempotent)."""
        if self._threads:
            return self
        self._stopping = False
        t = threading.Thread(target=self._serve_loop,
                             name="tm-serve-sync", daemon=True)
        self._threads = [t]
        t.start()
        return self
