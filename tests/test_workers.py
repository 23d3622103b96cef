"""Host worker-pool semantics (parallel/workers.py vs reference
workers.c behavior: policies, job numbers, sync, inline fallback)."""

import threading
import time

import numpy as np
import pytest

from art_jax.parallel import workers as w


def test_null_context_runs_inline():
    hits = []
    cxt = w.workers_init(0)
    assert cxt is None
    n = w.workers_enqueue_job(cxt, lambda c, j: hits.append(j), None, 42)
    assert n != 0 and hits == [42]
    w.workers_wait_all_jobs(cxt)
    w.workers_deinit(cxt)


def test_jobs_run_and_wait_all():
    pool = w.workers_init(3)
    out = np.zeros(32, dtype=np.int64)

    def job(_, i):
        time.sleep(0.001)
        out[i] = i * i

    nums = [pool.enqueue(job, None, i) for i in range(32)]
    assert all(n != 0 for n in nums)
    assert len(set(nums)) == 32
    pool.wait_all()
    np.testing.assert_array_equal(out, np.arange(32) ** 2)
    pool.deinit()


def test_dont_use_worker_runs_on_caller():
    pool = w.workers_init(2)
    tid = []
    pool.enqueue(lambda c, j: tid.append(threading.get_ident()), None, None,
                 policy=w.DONT_USE_WORKER_THREAD)
    assert tid == [threading.get_ident()]
    pool.deinit()


def test_fail_policy_returns_zero_when_saturated():
    pool = w.workers_init(1)
    release = threading.Event()
    pool.enqueue(lambda c, j: release.wait(), None, None)
    # the single worker is blocked -> fail policy must return 0
    deadline = time.time() + 2.0
    got0 = False
    while time.time() < deadline:
        if pool.enqueue(lambda c, j: None, None, None,
                        policy=w.FAIL_ON_NO_WORKER_AVAILABLE) == 0:
            got0 = True
            break
        time.sleep(0.005)
    release.set()
    pool.wait_all()
    pool.deinit()
    assert got0


def test_only_if_available_falls_back_inline():
    pool = w.workers_init(1)
    release = threading.Event()
    pool.enqueue(lambda c, j: release.wait(), None, None)
    tid = []
    n = pool.enqueue(lambda c, j: tid.append(threading.get_ident()), None,
                     None, policy=w.USE_WORKER_ONLY_IF_AVAILABLE)
    assert n != 0 and tid == [threading.get_ident()]
    release.set()
    pool.deinit()


def test_wait_on_job_and_is_running():
    pool = w.workers_init(2)
    release = threading.Event()
    n1 = pool.enqueue(lambda c, j: release.wait(), None, None)
    assert pool.is_job_running(n1)
    release.set()
    pool.wait_on_job(n1)
    assert not pool.is_job_running(n1)
    pool.deinit()


def test_worker_sync_orders_earlier_jobs():
    pool = w.workers_init(4)
    order = []
    lock = threading.Lock()
    slow_done = threading.Event()

    def slow(_, __):
        time.sleep(0.05)
        with lock:
            order.append("slow")
        slow_done.set()

    def synced(cxt, jobnum):
        pool.worker_sync(jobnum)
        with lock:
            order.append("synced")

    pool.enqueue(slow, None, None)
    # enqueue the synced job with its own job number as the payload
    holder = {}

    def synced_wrapper(cxt, _):
        while "n" not in holder:
            time.sleep(0.0005)
        synced(cxt, holder["n"])

    holder["n"] = pool.enqueue(synced_wrapper, None, None)
    pool.wait_all()
    assert order == ["slow", "synced"]
    pool.deinit()


def test_job_number_ordering_wraps():
    assert w.a_before_b(1, 2)
    assert not w.a_before_b(2, 1)
    assert w.a_before_b(0xFFFFFFF0, 5)      # across the uint32 wrap
    assert not w.a_before_b(5, 0xFFFFFFF0)
    assert not w.a_before_b(7, 7)


def test_debug_counters():
    """The reference's DEBUG counters (workers.c:27-29, 425-427):
    enqueues, FAIL_ON_NO_WORKER failures, inline runs, out-of-order
    completions."""
    import time

    from art_jax.parallel import workers as w

    pool = w.Workers(2)
    done = []
    pool.enqueue(lambda c, j: done.append(j), None, 1)
    pool.enqueue(lambda c, j: done.append(j), None, 2,
                 w.DONT_USE_WORKER_THREAD)
    pool.wait_all()
    # saturate, then fail-fast and inline policies
    ev = [w.threading.Event() for _ in range(2)]
    for e in ev:
        pool.enqueue(lambda c, j: j.wait(), None, e)
    time.sleep(0.02)
    assert pool.enqueue(lambda c, j: None, None, 0,
                        w.FAIL_ON_NO_WORKER_AVAILABLE) == 0
    pool.enqueue(lambda c, j: done.append(j), None, 3,
                 w.USE_WORKER_ONLY_IF_AVAILABLE)
    for e in ev:
        e.set()
    pool.wait_all()
    s = pool.stats
    assert s["enqueues"] == 5 and s["failures"] == 1
    assert s["inline_runs"] == 2
    assert s["out_of_order"] >= 0
    pool.deinit()


def test_deinit_debug_summary(monkeypatch, capsys):
    """ART_WORKERS_DEBUG prints the reference DEBUG-build deinit line
    (reference workers.c:425-427 format)."""
    monkeypatch.setenv("ART_WORKERS_DEBUG", "1")
    pool = w.Workers(2)
    for i in range(4):
        pool.enqueue(lambda c, j: None, None, i)
    pool.deinit()
    err = capsys.readouterr().err
    assert "total jobs = 4" in err
    assert "failures = 0" in err and "enqueues = 4" in err
    assert "currents =" in err and "unordered =" in err
