"""The port's serving layer (`repro_torch.core.serve`), held against the JAX
package's on the same survey and the same queries.

Ports every drill of tests/test_serve.py but the fault-injection one (the
port has no fault domain yet): coalescing (K concurrent compatible queries
= ONE `execute_batch`, one pass a pass), admission QoS (cheap before a
convoy; typed `Overloaded` at the queue and tenant caps), the result cache
(bitwise, hit counters), brick routing and the telemetry snapshot.  Every
response is bitwise the port's own `engine.run` and agrees with the
reference's `engine.run` at coadd atol 1e-3 / rtol 1e-4, depth exactly; the
scheduling counters equal the reference service's on the same burst.  Then
the drill (`repro_torch.launch.serve`) on the CPU, and the result-key
contract when a batch's union brings in a rejected NaN.
"""
import asyncio

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro.launch import serve as ref_launch
from repro_torch.launch import serve as port_launch

ATOL, RTOL = 1e-3, 1e-4
CFG = dict(n_runs=3, n_camcols=4, n_bands=3, n_fields=6, height=24, width=24,
           n_sources=120, seed=11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture(scope="module")
def engine(surveys):
    return rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")


@pytest.fixture(scope="module")
def ref_engine(surveys):
    return rc.CoaddEngine(surveys[0], pack_capacity=16)


def cheap_q(pkg, i, npix=48):
    lo = 37.1 + 0.12 * i
    return pkg.CoaddQuery(band="r", ra_bounds=(lo, lo + 0.4), dec_bounds=(-0.3, 0.3), npix=npix)


def monster_q(pkg, npix):
    return pkg.CoaddQuery(band="r", ra_bounds=(37.0, 38.5), dec_bounds=(-0.8, 0.8), npix=npix)


async def _queue_then_start(svc, queries, **submit_kw):
    """The deterministic burst pattern: enqueue everything, then start."""
    tasks = [asyncio.ensure_future(svc.submit(q, **submit_kw)) for q in queries]
    while svc.queue_depth < len(queries):
        await asyncio.sleep(0.005)
    async with svc:
        return await asyncio.gather(*tasks)


def _bitwise(got, want):
    np.testing.assert_array_equal(got.coadd.view(np.int32), want.coadd.view(np.int32))
    np.testing.assert_array_equal(got.depth.view(np.int32), want.depth.view(np.int32))


def _near_reference(got, want):
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_allclose(got.coadd, want.coadd, atol=ATOL, rtol=RTOL)


# ----- coalescing -----------------------------------------------------------

def test_concurrent_compatible_queries_one_dispatch(engine, ref_engine):
    """K compatible queries queued together = ONE engine dispatch (one pass),
    every response bitwise its own engine.run and near the reference's."""
    queries = [cheap_q(rt, i) for i in range(6)]
    serial = [engine.run(q, "sql_structured") for q in queries]
    svc = rt.CoaddService(engine, max_batch=16)
    d0 = engine.dispatch_count
    results = asyncio.run(_queue_then_start(svc, queries))
    assert engine.dispatch_count - d0 == 1
    assert svc.stats.dispatches == 1
    assert svc.stats.dispatched_queries == 6
    assert svc.stats.coalesce_factor == 6.0
    for i, (r, s) in enumerate(zip(results, serial)):
        _bitwise(r, s)
        _near_reference(r, ref_engine.run(cheap_q(rc, i), "sql_structured"))


def test_identical_inflight_queries_merge(engine):
    q = cheap_q(rt, 0)
    serial = engine.run(q, "sql_structured")
    svc = rt.CoaddService(engine)
    results = asyncio.run(_queue_then_start(svc, [q, q, q, q]))
    assert svc.stats.dispatches == 1
    assert svc.stats.merged_inflight == 3
    for r in results:
        _bitwise(r, serial)


def test_incompatible_npix_split_into_groups(engine, ref_engine):
    sizes = (48, 48, 32)
    qs = [cheap_q(rt, i, npix=n) for i, n in enumerate(sizes)]
    serial = [engine.run(q, "sql_structured") for q in qs]
    svc = rt.CoaddService(engine)
    results = asyncio.run(_queue_then_start(svc, qs))
    assert svc.stats.dispatches == 2
    for i, (r, s) in enumerate(zip(results, serial)):
        _bitwise(r, s)
        _near_reference(r, ref_engine.run(cheap_q(rc, i, npix=sizes[i]), "sql_structured"))


# ----- admission / QoS ------------------------------------------------------

def test_cheap_query_not_queued_behind_monsters(engine):
    order = []

    async def scenario():
        svc = rt.CoaddService(engine, cheap_budget=4)
        convoy = [monster_q(rt, 96), monster_q(rt, 112), monster_q(rt, 80)]

        async def client(tag, q):
            await svc.submit(q)
            order.append(tag)

        tasks = [asyncio.ensure_future(client(f"monster{i}", q)) for i, q in enumerate(convoy)]
        tasks.append(asyncio.ensure_future(client("cheap", cheap_q(rt, 0))))
        while svc.queue_depth < 4:
            await asyncio.sleep(0.005)
        async with svc:
            await asyncio.gather(*tasks)
        return svc

    svc = asyncio.run(scenario())
    assert order[0] == "cheap"
    assert svc.stats.cheap_dispatches == 1
    assert svc.stats.expensive_dispatches == 3


def test_overload_sheds_typed_queue_full(engine):
    async def scenario():
        svc = rt.CoaddService(engine, max_queue=2)
        tasks = [asyncio.ensure_future(svc.submit(cheap_q(rt, i))) for i in range(5)]
        await asyncio.sleep(0)
        async with svc:
            return svc, await asyncio.gather(*tasks, return_exceptions=True)

    svc, results = asyncio.run(scenario())
    shed = [r for r in results if isinstance(r, rt.Overloaded)]
    served = [r for r in results if not isinstance(r, Exception)]
    assert len(shed) == 3 and len(served) == 2
    assert all(e.reason == "queue_full" for e in shed)
    assert svc.stats.shed_queue_full == 3
    assert svc.stats.completed == 2


def test_tenant_inflight_cap(engine):
    async def scenario():
        svc = rt.CoaddService(engine, tenant_inflight=1)
        t = [asyncio.ensure_future(svc.submit(cheap_q(rt, 0), tenant="hog")),
             asyncio.ensure_future(svc.submit(cheap_q(rt, 1), tenant="hog")),
             asyncio.ensure_future(svc.submit(cheap_q(rt, 2), tenant="polite"))]
        await asyncio.sleep(0)
        async with svc:
            return svc, await asyncio.gather(*t, return_exceptions=True)

    svc, results = asyncio.run(scenario())
    assert isinstance(results[1], rt.Overloaded)
    assert results[1].reason == "tenant_cap"
    assert not isinstance(results[0], Exception)
    assert not isinstance(results[2], Exception)
    assert svc.stats.shed_tenant_cap == 1


@pytest.mark.parametrize("bad", [dict(max_queue=0), dict(max_batch=0)])
def test_service_rejects_bad_limits(engine, bad):
    with pytest.raises(ValueError, match="must be positive"):
        rt.CoaddService(engine, **bad)


# ----- result cache ---------------------------------------------------------

def test_result_cache_bitwise_parity_and_counters(engine):
    q = cheap_q(rt, 3)

    async def scenario():
        async with rt.CoaddService(engine) as svc:
            first = await svc.submit(q)
            d = svc.stats.dispatches
            again = await svc.submit(q)
            return svc, d, first, again

    svc, d_after_first, first, again = asyncio.run(scenario())
    assert svc.stats.cache_hits == 1
    assert svc.stats.dispatches == d_after_first
    _bitwise(first, again)
    _bitwise(again, engine.run(q, "sql_structured"))


def test_result_key_tracks_psf_state(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    k0 = eng.result_key(eng.plan(cheap_q(rt, 0), "sql_structured"))
    eng.match_psf_sigma = 2.0
    assert eng.result_key(eng.plan(cheap_q(rt, 0), "sql_structured")) != k0


def test_queued_duplicate_served_from_cache_after_first_completes(engine):
    q_hot = cheap_q(rt, 5)

    async def scenario():
        async with rt.CoaddService(engine) as svc:
            await svc.submit(q_hot)
            r = await svc.submit(q_hot)
            return svc, r

    svc, r = asyncio.run(scenario())
    assert svc.stats.cache_hits == 1
    _bitwise(r, engine.run(q_hot, "sql_structured"))


def test_cache_disabled_and_evicted(engine):
    async def scenario(entries):
        async with rt.CoaddService(engine, cache_entries=entries) as svc:
            for i in (0, 1, 0):
                await svc.submit(cheap_q(rt, i))
            return svc

    assert asyncio.run(scenario(0)).stats.cache_hits == 0
    assert asyncio.run(scenario(1)).stats.cache_hits == 0     # 0 evicted by 1
    assert asyncio.run(scenario(2)).stats.cache_hits == 1


# ----- brick routing --------------------------------------------------------

def test_brick_aligned_queries_route_to_mosaic(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, brick_npix=32, device="cpu")
    q = eng.brick_grid.window_query(1, 2, 1, 2, "r")
    want = eng.run_window(q, "sql_structured")

    async def one():
        async with rt.CoaddService(eng, use_bricks=True) as svc:
            r = await svc.submit(q)
        return svc, r

    svc1, r1 = asyncio.run(one())
    assert svc1.stats.brick_routed == 1
    _bitwise(r1, want)
    assert svc1.brick_popularity[("r", 1, 2, 1, 2)] == [0, 1]
    svc2, r2 = asyncio.run(one())
    assert svc2.brick_popularity[("r", 1, 2, 1, 2)] == [1, 0]
    assert svc2.stats.bricks_hit >= 1
    _bitwise(r2, want)

    async def unaligned():
        async with rt.CoaddService(eng, use_bricks=True) as svc:
            await svc.submit(cheap_q(rt, 0))
            return svc

    assert asyncio.run(unaligned()).stats.brick_routed == 0


# ----- telemetry, and the reference's scheduling ---------------------------

def test_service_stats_snapshot_shape(engine):
    import json

    svc = rt.CoaddService(engine)
    results = asyncio.run(_queue_then_start(svc, [cheap_q(rt, 0), cheap_q(rt, 1)]))
    assert len(results) == 2
    snap = svc.stats.snapshot()
    for field in ("submitted", "admitted", "dispatches", "coalesce_factor",
                  "p50_ms", "p95_ms", "p99_ms", "queue_depth_peak"):
        assert field in snap
    assert snap["submitted"] == 2 and snap["p95_ms"] >= 0.0
    json.dumps(snap)


COUNTERS = ("submitted", "admitted", "completed", "dispatches", "dispatched_queries",
            "cheap_dispatches", "expensive_dispatches", "cache_hits", "cache_misses",
            "merged_inflight", "queue_depth_peak")


@pytest.mark.parametrize("seed", [0, 3])
def test_drill_burst_schedules_as_the_reference(surveys, engine, ref_engine, seed):
    """The drill's burst shape on this survey through both services: the same
    groups (counters equal) and every response near the reference's."""
    got_q = port_launch.drill_queries(seed, 16, 8)
    want_q = ref_launch.drill_queries(seed, 16, 8)
    assert [(q.band, q.ra_bounds, q.dec_bounds, q.npix) for q in got_q] == [
        (q.band, q.ra_bounds, q.dec_bounds, q.npix) for q in want_q]
    svc_g, res_g, _ = asyncio.run(port_launch.run_service(engine, got_q))
    svc_w, res_w, _ = asyncio.run(ref_launch._run_service(
        ref_engine, want_q, type("Args", (), dict(method="sql_structured", max_queue=64,
                                                  max_batch=16))()))
    for f in COUNTERS:
        assert getattr(svc_g.stats, f) == getattr(svc_w.stats, f), f
    assert svc_g.stats.coalesce_factor > 1.0
    for q, g, w in zip(got_q, res_g, res_w):
        _near_reference(g, w)
        _bitwise(g, engine.run(q, "sql_structured"))


def test_drill_passes_on_cpu(capsys):
    out = port_launch.main(["--clients", "16", "--drill", "--device", "cpu"])
    assert out["bitwise_mismatches"] == 0 and out["device"] == "cpu"
    assert out["stats"]["coalesce_factor"] > 1.0 and out["stats"]["completed"] == 16
    assert "DRILL OK" in capsys.readouterr().out


def test_drill_reports_each_violation(engine):
    q = [cheap_q(rt, 0), cheap_q(rt, 1)]
    svc = rt.CoaddService(engine)
    results = asyncio.run(_queue_then_start(svc, q[:1]))
    wrong = {q[0]: engine.run(q[1], "sql_structured")}
    mismatched, failures = port_launch.drill_failures(svc, q[:1], results, wrong, 2)
    assert mismatched == 1 and len(failures) == 3
    assert any("differ bitwise" in f for f in failures)
    assert any("coalesce factor" in f for f in failures)
    assert any("completed 1 != 2" in f for f in failures)


# ----- a batch whose union brings in a rejected NaN -------------------------

def test_union_nan_never_answers_a_request_alone():
    """A burst of an r and a g query over the same box, where a g frame holds
    a NaN: the r response comes from the batch (NaNs from the union's g
    pack, as in the reference's batch), is cached under a key of its own,
    and a later r request alone runs its own scan: finite and bitwise
    engine.run."""
    sv = rt.make_survey(rt.SurveyConfig(**CFG))
    box = dict(ra_bounds=(37.3, 37.8), dec_bounds=(-0.3, 0.3), npix=32)
    hit = next(im for im in sv.images if im.band == "g"
               and im.bounds[0] < 37.55 < im.bounds[1] and im.bounds[2] < 0.1 < im.bounds[3])
    h, w = hit.pixels.shape
    hit.pixels[h // 2, w // 2] = np.nan
    eng = rt.CoaddEngine(sv, pack_capacity=8, device="cpu")
    r_q, g_q = rt.CoaddQuery(band="r", **box), rt.CoaddQuery(band="g", **box)
    alone = eng.run(r_q, "sql_structured")
    assert np.isfinite(alone.coadd).all()

    async def scenario():
        svc = rt.CoaddService(eng)
        burst = await _queue_then_start(svc, [r_q, g_q])
        async with svc:
            later = await svc.submit(r_q)
        return svc, burst, later

    svc, (r_batch, _), later = asyncio.run(scenario())
    assert svc.stats.dispatches == 2 and svc.stats.cache_hits == 0
    assert np.isnan(r_batch.coadd).any() and r_batch.stats.batch_scan != ""
    _bitwise(later, alone)


def test_service_modules_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch.core.serve, repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "assert 'jaxlib' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
