"""The port's `JobTracker` (image-shard map tasks with journaling, retry and
speculative backup), held against the JAX package's.

Ports ``tests/test_jobtracker.py``.  The port's executor is its plain
coadd of one shard (`engine._accept_from_meta`, `mapper.map_batch`,
`reducer.reduce_local`, on the CPU), the reference's its jitted
``_coadd_batch``, as its test runs it.  Every combined result is held
against the reference tracker's fault-free run on the same shards: depth
exactly, coadd at the tolerance the port's engine tests hold the two
packages to (atol 1e-3 / rtol 1e-4, tests/test_torch_serve.py) and, within
the port, re-executed and
repartitioned runs against the port's own as the reference's test holds
its own.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as rtc
from repro.core.engine import _coadd_batch as ref_coadd_batch
from repro.core.engine import _query_vec as ref_query_vec
from repro.core.mapper import query_grid_sky as ref_grid
from repro_torch.core import mapper, reducer
from repro_torch.core.engine import _accept_from_meta, _query_vec

CFG = dict(n_runs=2, n_fields=4, n_sources=50, height=16, width=16)
QUERY = dict(band="g", ra_bounds=(37.2, 37.8), dec_bounds=(-0.6, 0.4), npix=32)
INTS = ("image_id", "run", "camcol", "band_id", "field")
FLOATS = ("t_obs", "ra_min", "ra_max", "dec_min", "dec_max")

SURVEY = rtc.make_survey(rtc.SurveyConfig(**CFG))
IDS = rtc.SpatialIndex.build(SURVEY).select(rtc.CoaddQuery(**QUERY))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def executor(image_ids):
    """The port's plain coadd of one shard of images."""
    ids = list(image_ids)
    tab = SURVEY.meta_table()
    px = torch.from_numpy(np.stack([SURVEY.images[i].pixels for i in ids]))
    wcs = torch.from_numpy(np.stack([SURVEY.images[i].wcs.to_vector() for i in ids]))
    ints = {k: torch.from_numpy(np.asarray(tab[k][ids])) for k in INTS}
    floats = {k: torch.from_numpy(np.asarray(tab[k][ids])) for k in FLOATS}
    query = rtc.CoaddQuery(**QUERY)
    accept = _accept_from_meta(ints, floats, torch.from_numpy(_query_vec(query)))
    gr, gd = (torch.from_numpy(a) for a in mapper.query_grid_sky(query))
    tiles, covs = mapper.map_batch(px, wcs, accept, gr, gd)
    return reducer.reduce_local(tiles, covs)


def ref_executor(image_ids):
    """The reference's jitted ``_coadd_batch`` of one shard (its test's)."""
    import jax.numpy as jnp
    survey = ref_survey()
    ids = list(image_ids)
    tab = survey.meta_table()
    px = np.stack([survey.images[i].pixels for i in ids])
    query = rc.CoaddQuery(**QUERY)
    gr, gd = ref_grid(query)
    c, d, _ = ref_coadd_batch(
        jnp.asarray(px), jnp.asarray(np.stack([survey.images[i].wcs.to_vector() for i in ids])),
        {k: jnp.asarray(tab[k][ids]) for k in INTS}, {k: jnp.asarray(tab[k][ids]) for k in FLOATS},
        jnp.asarray(ref_query_vec(query)), jnp.asarray(gr), jnp.asarray(gd))
    return np.asarray(c), np.asarray(d)


_REF = {}


def ref_survey():
    if "survey" not in _REF:
        _REF["survey"] = rc.make_survey(rc.SurveyConfig(**CFG))
    return _REF["survey"]


def reference():
    """The reference tracker's fault-free run over 4 shards."""
    if "result" not in _REF:
        ids = rc.SpatialIndex.build(ref_survey()).select(rc.CoaddQuery(**QUERY))
        assert np.array_equal(ids, IDS)
        t = rc.JobTracker(ref_executor, n_workers=4)
        _REF["result"] = t.run(rc.JobTracker.split(ids, 4))
    return _REF["result"]


def port_clean():
    t = rtc.JobTracker(executor, n_workers=4)
    return t.run(rtc.JobTracker.split(IDS, 4))


def _as_reference(c, d):
    ref_c, ref_d = reference()
    assert d.max() > 0
    np.testing.assert_array_equal(d, ref_d)
    np.testing.assert_allclose(c, ref_c, atol=1e-3, rtol=1e-4)


def test_failure_reexecution_preserves_result():
    ref_c, ref_d = port_clean()
    inj = rtc.FailureInjector({(0, 0): "fail", (2, 0): "fail", (2, 1): "fail"})
    t = rtc.JobTracker(executor, n_workers=4, injector=inj)
    c, d = t.run(rtc.JobTracker.split(IDS, 4))
    np.testing.assert_allclose(c, ref_c, atol=1e-4)
    np.testing.assert_array_equal(d, ref_d)
    assert any("retry" in e for e in t.events)
    _as_reference(c, d)


def test_retries_exhausted_raises():
    inj = rtc.FailureInjector({(1, a): "fail" for a in range(5)})
    t = rtc.JobTracker(executor, n_workers=2, max_attempts=3, injector=inj)
    with pytest.raises(RuntimeError, match="exhausted"):
        t.run(rtc.JobTracker.split(IDS, 3))


def test_journal_replay_skips_done_tasks():
    t = rtc.JobTracker(executor, n_workers=2)
    tasks = rtc.JobTracker.split(IDS, 3)
    c, d = t.run(tasks)
    n_events = len(t.events)
    c2, d2 = t.run(tasks)  # restart: everything journaled
    hits = [e for e in t.events[n_events:] if "journal-hit" in e]
    assert len(hits) == len(tasks)
    np.testing.assert_array_equal(c2, c)
    _as_reference(c2, d2)


def test_speculative_execution_verifies_determinism():
    inj = rtc.FailureInjector({(0, 0): "slow"}, slow_s=0.01)
    t = rtc.JobTracker(executor, n_workers=2, straggler_threshold_s=0.005, injector=inj)
    c, d = t.run(rtc.JobTracker.split(IDS, 2))
    ref_c, _ = port_clean()
    np.testing.assert_allclose(c, ref_c, atol=1e-4)
    assert "speculative task=0" in t.events, t.events
    _as_reference(c, d)


def test_elastic_repartition_same_result():
    ref_c, ref_d = port_clean()
    for n_tasks in (1, 2, 5, len(IDS)):
        t = rtc.JobTracker(executor, n_workers=3)
        c, d = t.run(rtc.JobTracker.split(IDS, n_tasks))
        np.testing.assert_allclose(c, ref_c, atol=1e-3)
        np.testing.assert_array_equal(d, ref_d)
        _as_reference(c, d)


def test_non_runtime_transient_errors_are_retried():
    """Transient failures of ANY classified type (not just RuntimeError)
    consume a retry and re-execute to the same result."""
    ref_c, ref_d = port_clean()
    inj = rtc.FailureInjector({(0, 0): "fail_os", (1, 0): "fail_transient"})
    t = rtc.JobTracker(executor, n_workers=4, injector=inj)
    c, d = t.run(rtc.JobTracker.split(IDS, 4))
    np.testing.assert_allclose(c, ref_c, atol=1e-4)
    np.testing.assert_array_equal(d, ref_d)
    assert sum("retry" in e for e in t.events) == 2
    _as_reference(c, d)


def test_fatal_errors_escape_the_retry_net():
    """Fatal errors (ValueError here; DeterminismError in production) escape
    immediately: re-rolling them is wrong."""
    inj = rtc.FailureInjector({(0, 0): "fail_fatal"})
    t = rtc.JobTracker(executor, n_workers=4, injector=inj)
    with pytest.raises(ValueError):
        t.run(rtc.JobTracker.split(IDS, 4))
    assert not any("retry" in e for e in t.events)
