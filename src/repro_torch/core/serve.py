"""Coadd-as-a-service: the async multi-tenant front end (DESIGN.md §10).

Counterpart of ``repro.core.serve``.  A bare `CoaddEngine` answers one caller
at a time; this is the serving layer on top of it:

  queue → admit → coalesce → dispatch → cache

* **Coalescing.**  Every request is planned at admission; plans that share a
  `CoaddPlan.coalesce_key` (layout, npix, grid override, PSF target,
  estimator) drain from the queue together and run as ONE
  `CoaddEngine.execute_batch`: on the card one launch of each batched pass
  kernel for all of them.  The window is natural, not a timer: while one
  dispatch holds the (single) engine worker, arrivals pile up in the queue
  and the next drain takes them all.  Requests with identical
  `CoaddEngine.result_key`s merge further (singleflight): one plan runs and
  every duplicate resolves from the same pixels.

* **Admission / QoS.**  Beyond ``max_queue`` open requests (or a tenant's
  ``tenant_inflight``), `submit` raises `Overloaded` before any engine work.
  Admitted plans are classed cheap or expensive on `CoaddPlan.cost_budget`,
  and the drain runs weighted round-robin between the classes (3:1 cheap by
  default), so a small query never queues behind a convoy of whole-survey
  ones.

* **Result cache.**  Completed results are kept in an LRU keyed on
  `CoaddEngine.result_key`, whose contract is "equal keys ⇒ bitwise-equal
  coadds".  A batch's result is stored under the key the engine gives it
  with that result (`result_key(plan, result)`): the plan's own key when the
  batch's scan is bitwise its own run's, a key of its own otherwise.  With
  ``use_bricks=True`` brick-aligned queries route to the mosaic path
  (`run(use_bricks=True)`), and per-cover hit/miss tallies
  (`brick_popularity`) say what to materialize next.

* **Telemetry.**  `ServiceStats`: admission, dispatch, cache and brick
  counters, queue depth and p50/p95/p99 latency, with a JSON-ready
  `snapshot()`.

Threading: an asyncio front end and ONE worker thread for every engine touch
(planning and dispatch), so the engine, which is not thread-safe, stays
single-threaded while the event loop admits, sheds and resolves futures.
All service state is changed on the loop thread only.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import CoaddEngine, CoaddResult
from repro_torch.core.plan import CoaddPlan
from repro_torch.core.query import CoaddQuery


class Overloaded(RuntimeError):
    """Typed admission rejection: the caller should back off and retry.

    ``reason`` is ``"queue_full"`` (the service's open-request limit) or
    ``"tenant_cap"`` (a tenant's in-flight limit).  Raised before any engine
    work is spent on the request.
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"service overloaded ({reason}): {detail}")
        self.reason = reason


@dataclasses.dataclass
class ServiceStats:
    """Serving telemetry: admission (submitted/admitted/shed_*), dispatch
    (dispatches and dispatched_queries, hence the coalesce factor), result
    cache (hits/misses/merged_inflight), brick routing, faults (the retries
    the engine's fault domain made in served results), and latency
    (p50/p95/p99 over completed requests, cache hits included)."""

    submitted: int = 0
    admitted: int = 0
    shed_queue_full: int = 0
    shed_tenant_cap: int = 0
    completed: int = 0
    failed: int = 0
    # One dispatch = one engine entry (execute, execute_batch or a brick
    # mosaic) the service issued; dispatched_queries = requests those
    # entries answered, in-flight merges included, cache hits excluded.
    dispatches: int = 0
    dispatched_queries: int = 0
    cheap_dispatches: int = 0
    expensive_dispatches: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    merged_inflight: int = 0
    brick_routed: int = 0
    bricks_hit: int = 0
    bricks_missed: int = 0
    retries: int = 0
    queue_depth: int = 0
    queue_depth_peak: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_tenant_cap

    @property
    def coalesce_factor(self) -> float:
        """Requests answered per engine dispatch (1.0: no coalescing)."""
        if self.dispatches == 0:
            return 0.0 if self.dispatched_queries == 0 else float("inf")
        return self.dispatched_queries / self.dispatches

    def latency_ms(self, pct: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), pct) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50.0)

    @property
    def p95_ms(self) -> float:
        return self.latency_ms(95.0)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99.0)

    def snapshot(self) -> Dict[str, float]:
        """JSON-ready view (without the raw latency list)."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "latencies_s"}
        d["coalesce_factor"] = round(self.coalesce_factor, 3)
        d["p50_ms"] = round(self.p50_ms, 3)
        d["p95_ms"] = round(self.p95_ms, 3)
        d["p99_ms"] = round(self.p99_ms, 3)
        return d


@dataclasses.dataclass(eq=False)  # identity equality: queue removal must
class _Pending:                   # never compare the numpy gate payloads
    """One admitted request waiting in the queue."""

    plan: CoaddPlan
    key: str                  # engine.result_key(plan): the merge identity
    cls: str                  # "cheap" | "expensive" (cost_budget class)
    future: "asyncio.Future[CoaddResult]"


class CoaddService:
    """Async multi-tenant front end over one `CoaddEngine` (DESIGN.md §10).

    Usage::

        async with CoaddService(engine, max_queue=64) as svc:
            results = await asyncio.gather(*(svc.submit(q) for q in queries))

    ``submit`` may be called before `start`: requests queue up and the first
    drain after `start` coalesces them (a recorded burst, replayed).

    ``method`` is the locate method of `submit(query)` without one;
    ``max_queue`` the open-request limit; ``max_batch`` the largest group a
    dispatch takes; ``cheap_budget`` the `cost_budget` at or below which a
    plan is cheap (None: a quarter of its layout's packs); ``cheap_weight``
    the cheap class's round-robin weight against 1; ``tenant_inflight`` a
    tenant's open-request cap (None: none); ``cache_entries`` the result
    LRU's size (0: no cache); ``use_bricks`` routes brick-aligned queries to
    the mosaic path.
    """

    def __init__(
        self,
        engine: CoaddEngine,
        *,
        method: str = "sql_structured",
        max_queue: int = 64,
        max_batch: int = 16,
        cheap_budget: Optional[int] = None,
        cheap_weight: int = 3,
        tenant_inflight: Optional[int] = None,
        cache_entries: int = 128,
        use_bricks: bool = False,
    ):
        if max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self.engine = engine
        self.method = method
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.cheap_budget = cheap_budget
        self.cheap_weight = max(int(cheap_weight), 1)
        self.tenant_inflight = tenant_inflight
        self.cache_entries = cache_entries
        self.use_bricks = use_bricks

        self.stats = ServiceStats()
        # (band, r0, r1, c0, c1) cover tag -> [warm serves, cold misses].
        self.brick_popularity: Dict[Tuple, List[int]] = {}

        self._queue: Deque[_Pending] = collections.deque()
        self._cache: "collections.OrderedDict[str, CoaddResult]" = collections.OrderedDict()
        self._open_total = 0
        self._open_tenant: Dict[str, int] = collections.defaultdict(int)
        self._credits = {"cheap": 0.0, "expensive": 0.0}
        self._worker: Optional[ThreadPoolExecutor] = None
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False

    # ----- lifecycle -----
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._wake = asyncio.Event()
        if self._queue:
            self._wake.set()
        self._task = asyncio.get_running_loop().create_task(self._dispatch_loop())

    async def stop(self) -> None:
        """Drain the queue, then stop the dispatcher (idempotent)."""
        if not self._running:
            return
        self._running = False
        self._wake.set()
        await self._task
        self._task = None
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    async def __aenter__(self) -> "CoaddService":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # ----- submission -----
    async def submit(self, query: CoaddQuery, method: Optional[str] = None,
                     tenant: str = "default") -> CoaddResult:
        """Admit, plan and eventually answer one query.

        Raises `Overloaded` (shed, before any engine work), or re-raises the
        error the engine hit running the plan.
        """
        m = method or self.method
        self.stats.submitted += 1
        if self._open_total >= self.max_queue:
            self.stats.shed_queue_full += 1
            raise Overloaded("queue_full", f"{self._open_total} open >= {self.max_queue}")
        cap = self.tenant_inflight
        if cap is not None and self._open_tenant[tenant] >= cap:
            self.stats.shed_tenant_cap += 1
            raise Overloaded("tenant_cap", f"tenant {tenant!r} at {cap} in flight")
        self.stats.admitted += 1
        self._open_total += 1
        self._open_tenant[tenant] += 1
        t0 = time.perf_counter()
        try:
            result = await self._serve(query, m)
        except Exception:
            self.stats.failed += 1
            raise
        else:
            self.stats.completed += 1
            self.stats.latencies_s.append(time.perf_counter() - t0)
            return result
        finally:
            self._open_total -= 1
            self._open_tenant[tenant] -= 1

    async def _serve(self, query: CoaddQuery, method: str) -> CoaddResult:
        loop = asyncio.get_running_loop()
        if self.use_bricks:
            routed = await self._maybe_route_bricks(query, method)
            if routed is not None:
                return routed
        plan = await loop.run_in_executor(self._ensure_worker(), self.engine.plan, query, method)
        key = self.engine.result_key(plan)
        cached = self._cache_get(key)
        if cached is not None:
            self.stats.cache_hits += 1
            return cached
        self.stats.cache_misses += 1
        pend = _Pending(plan=plan, key=key, cls=self._classify(plan),
                        future=loop.create_future())
        self._queue.append(pend)
        self.stats.queue_depth = len(self._queue)
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak, self.stats.queue_depth)
        if self._wake is not None:
            self._wake.set()
        return await pend.future

    async def _maybe_route_bricks(self, query: CoaddQuery,
                                  method: str) -> Optional[CoaddResult]:
        """Serve a brick-aligned query by the mosaic path, or None.

        Aligned queries always take it when ``use_bricks`` is on (cold
        covers materialize inline, as `run(use_bricks=True)` does), so their
        answers stay on the lattice grid; warmth only feeds the tallies.
        """
        loop = asyncio.get_running_loop()
        cover = self.engine.brick_grid.decompose(query)
        if cover is None:
            return None
        # Store warmth is engine state: read it on the engine worker.
        warm = await loop.run_in_executor(
            self._ensure_worker(), self.engine.warm_brick_cover, query) is not None
        tally = self.brick_popularity.setdefault(cover.tag, [0, 0])
        tally[0 if warm else 1] += 1
        # Mosaic pixels depend on the cover and the PSF state, not the method.
        key = f"brick|{cover.tag}|{self.engine._psf_state()}"
        cached = self._cache_get(key)
        if cached is not None:
            self.stats.cache_hits += 1
            return cached
        self.stats.cache_misses += 1
        result = await loop.run_in_executor(
            self._ensure_worker(), lambda: self.engine.run(query, method, use_bricks=True))
        self.stats.brick_routed += 1
        self.stats.bricks_hit += result.stats.bricks_hit
        self.stats.bricks_missed += result.stats.bricks_missed
        self.stats.retries += result.stats.retries
        self.stats.dispatches += 1
        self.stats.dispatched_queries += 1
        self._cache_put(key, result)
        return result

    # ----- dispatcher -----
    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not self._queue:
                if not self._running:
                    return
                self._wake.clear()
                if self._queue:  # raced with an enqueue
                    continue
                await self._wake.wait()
                continue
            group = self._select_group()
            self.stats.queue_depth = len(self._queue)
            if not group:
                continue
            try:
                keys, cache_keys, results = await loop.run_in_executor(
                    self._ensure_worker(), self._execute_group, group)
            except Exception as exc:
                for p in group:
                    if not p.future.done():
                        p.future.set_exception(exc)
                continue
            by_key = dict(zip(keys, results))
            self.stats.dispatches += 1
            self.stats.dispatched_queries += len(group)
            if group[0].cls == "cheap":
                self.stats.cheap_dispatches += 1
            else:
                self.stats.expensive_dispatches += 1
            self.stats.merged_inflight += len(group) - len(keys)
            for key, res in zip(cache_keys, results):
                self.stats.retries += res.stats.retries
                self._cache_put(key, res)
            for p in group:
                if not p.future.done():
                    p.future.set_result(by_key[p.key])

    def _select_group(self) -> List[_Pending]:
        """Drain one coalescible group from the queue (loop thread).

        First resolves every pending whose key reached the cache since it
        was queued, then picks a class by weighted round-robin and takes the
        queued plans that share its oldest pending's coalesce key, up to
        ``max_batch``.
        """
        for p in list(self._queue):
            hit = self._cache_get(p.key)
            if hit is not None:
                self._queue.remove(p)
                self.stats.cache_hits += 1
                self.stats.cache_misses -= 1   # counted at admission; never dispatched
                if not p.future.done():
                    p.future.set_result(hit)
        if not self._queue:
            return []
        cheap = [p for p in self._queue if p.cls == "cheap"]
        expensive = [p for p in self._queue if p.cls == "expensive"]
        if cheap and expensive:
            total = self.cheap_weight + 1.0
            self._credits["cheap"] += self.cheap_weight
            self._credits["expensive"] += 1.0
            pick = ("cheap" if self._credits["cheap"] >= self._credits["expensive"]
                    else "expensive")
            self._credits[pick] -= total
        else:
            pick = "cheap" if cheap else "expensive"
        pool = cheap if pick == "cheap" else expensive
        lead = pool[0]
        group = [p for p in pool if p.plan.coalesce_key == lead.plan.coalesce_key]
        group = group[: self.max_batch]
        for p in group:
            self._queue.remove(p)
        return group

    def _execute_group(self, group: List[_Pending]
                       ) -> Tuple[List[str], List[str], List[CoaddResult]]:
        """Worker thread: merge identical plans, run ONE engine dispatch ->
        (merge keys, cache keys, results).

        A group of one runs `execute` (trivially its own run); a larger one
        `execute_batch` over the distinct plans.  Each result's cache key is
        `CoaddEngine.result_key(plan, result)`.
        """
        uniq: "collections.OrderedDict[str, CoaddPlan]" = collections.OrderedDict()
        for p in group:
            uniq.setdefault(p.key, p.plan)
        plans = list(uniq.values())
        if len(plans) == 1:
            results = [self.engine.execute(plans[0])]
        else:
            results = self.engine.execute_batch(plans)
        cache_keys = [self.engine.result_key(p, r) for p, r in zip(plans, results)]
        return list(uniq.keys()), cache_keys, results

    # ----- helpers -----
    def _ensure_worker(self) -> ThreadPoolExecutor:
        if self._worker is None:
            self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="coadd-serve")
        return self._worker

    def _classify(self, plan: CoaddPlan) -> str:
        cheap_at = self.cheap_budget
        if cheap_at is None:
            cheap_at = max(1, plan.gate.shape[0] // 4)
        return "cheap" if plan.cost_budget <= cheap_at else "expensive"

    def _cache_get(self, key: str) -> Optional[CoaddResult]:
        res = self._cache.get(key)
        if res is not None:
            self._cache.move_to_end(key)
        return res

    def _cache_put(self, key: str, result: CoaddResult) -> None:
        if self.cache_entries <= 0:
            return
        self._cache[key] = result
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)


__all__ = ["CoaddService", "Overloaded", "ServiceStats"]
