"""Coadd-serving CLI: demo and seeded concurrency drill for `CoaddService`.

Counterpart of ``repro.launch.serve``: concurrent multi-tenant coadd queries
through the async front end (`repro_torch.core.serve`, DESIGN.md §10),
coalesced into the engine's batched scans.  Runs on the card by default.

Demo:
  PYTHONPATH=src python -m repro_torch.launch.serve --clients 16

Drill: the same run, then the serving contract is asserted (every response
bitwise a direct `engine.run`, coalesce factor above 1, nothing shed below
the admission limit, every client answered) and any violation exits 1:
  PYTHONPATH=src python -m repro_torch.launch.serve --clients 16 --drill
  PYTHONPATH=src python -m repro_torch.launch.serve --clients 16 --drill --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core import CoaddEngine, CoaddQuery, CoaddService, SurveyConfig, make_survey

DRILL_SURVEY = SurveyConfig(
    n_runs=4, n_camcols=4, n_bands=3, n_fields=6,
    height=24, width=24, n_sources=150, seed=9,
)


class DrillShape(NamedTuple):
    """The drill's query pool: cheap boxes ``cheap_width`` deg wide starting at
    ``cheap_ra0 + i * cheap_step`` over ``cheap_dec``, and a whole-footprint
    query (``monster_ra`` x ``monster_dec``) at a larger grid."""

    cheap_ra0: float
    cheap_step: float
    cheap_width: float
    cheap_dec: Tuple[float, float]
    cheap_npix: int
    monster_ra: Tuple[float, float]
    monster_dec: Tuple[float, float]
    monster_npix: int


#: The reference drill's pool over `DRILL_SURVEY` (RA 37-38.5, Dec +-0.8).
DRILL_SHAPE = DrillShape(37.1, 0.15, 0.4, (-0.3, 0.3), 64, (37.0, 38.5), (-0.8, 0.8), 96)


def drill_queries(seed: int, clients: int, pool: int, shape: DrillShape = DRILL_SHAPE):
    """Seeded multi-tenant workload: a skewed draw over a mixed query pool.

    The pool interleaves cheap boxes with whole-footprint queries (every
    fourth) at a different npix, so the two classes share neither a
    coalesce group nor a cost class; clients draw with Zipf-like
    popularity, so repeats (what the cache and the in-flight merge are for)
    occur.
    """
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(pool):
        if i % 4 == 3:
            qs.append(CoaddQuery(band="r", ra_bounds=shape.monster_ra,
                                 dec_bounds=shape.monster_dec, npix=shape.monster_npix))
        else:
            lo = shape.cheap_ra0 + shape.cheap_step * i
            qs.append(CoaddQuery(band="r", ra_bounds=(lo, lo + shape.cheap_width),
                                 dec_bounds=shape.cheap_dec, npix=shape.cheap_npix))
    w = 1.0 / np.arange(1, pool + 1)
    picks = rng.choice(pool, size=clients, p=w / w.sum())
    return [qs[int(i)] for i in picks]


async def run_service(engine, queries, method="sql_structured", max_queue=64, max_batch=16):
    """Queue the whole burst, then start the dispatcher (the recorded-burst
    replay, which makes the coalescing deterministic) -> (service, results,
    wall seconds)."""
    svc = CoaddService(engine, method=method, max_queue=max_queue, max_batch=max_batch)
    tasks = [asyncio.ensure_future(svc.submit(q, tenant=f"t{i % 4}"))
             for i, q in enumerate(queries)]
    while svc.queue_depth < len(queries):
        await asyncio.sleep(0.005)
    t0 = time.perf_counter()
    async with svc:
        results = await asyncio.gather(*tasks)
    return svc, results, time.perf_counter() - t0


def drill_failures(svc, queries, results, serial, clients):
    """The serving contract's violations -> (mismatched responses, messages)."""
    mismatched = sum(
        not (np.array_equal(r.coadd.view(np.int32), serial[q].coadd.view(np.int32))
             and np.array_equal(r.depth.view(np.int32), serial[q].depth.view(np.int32)))
        for q, r in zip(queries, results))
    failures = []
    if mismatched:
        failures.append(f"{mismatched}/{clients} responses differ bitwise from direct "
                        "engine.run")
    if not svc.stats.coalesce_factor > 1.0:
        failures.append(f"coalesce factor {svc.stats.coalesce_factor:.2f} <= 1")
    if svc.stats.shed != 0:
        failures.append(f"{svc.stats.shed} requests shed below the admission limit")
    if svc.stats.completed != clients:
        failures.append(f"completed {svc.stats.completed} != {clients}")
    return mismatched, failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--pool", type=int, default=8, help="distinct queries the clients draw from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="sql_structured")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--drill", action="store_true",
                    help="assert the serving contract; exit 1 on a violation")
    args = ap.parse_args(argv)

    survey = make_survey(DRILL_SURVEY)
    engine = CoaddEngine(survey, pack_capacity=16, device=args.device)
    queries = drill_queries(args.seed, args.clients, args.pool)

    # The serial reference: each distinct query straight through the engine.
    serial = {}
    t0 = time.perf_counter()
    for q in queries:
        if q not in serial:
            serial[q] = engine.run(q, args.method)
    t_serial_unique = time.perf_counter() - t0

    svc, results, wall = asyncio.run(run_service(engine, queries, args.method,
                                                 args.max_queue, args.max_batch))
    snap = svc.stats.snapshot()
    mismatched, failures = drill_failures(svc, queries, results, serial, args.clients)
    out = {
        "clients": args.clients,
        "distinct": len(serial),
        "device": str(engine.device),
        "wall_s": round(wall, 4),
        "serial_unique_s": round(t_serial_unique, 4),
        "bitwise_mismatches": mismatched,
        "stats": snap,
    }
    print(json.dumps(out, indent=1))
    if args.drill:
        if failures:
            for f in failures:
                print(f"DRILL FAIL: {f}")
            raise SystemExit(1)
        print(f"DRILL OK: {args.clients} clients, {snap['dispatches']} dispatches, "
              f"coalesce {snap['coalesce_factor']}x, 0 shed, bitwise clean")
    return out


if __name__ == "__main__":
    main()
