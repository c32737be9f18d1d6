
def test_prefetch_abandoned_epoch_releases_worker():
    """Abandoning the prefetch generator mid-epoch must stop the worker
    thread (ADVICE r4 low: it used to block forever on q.put)."""
    import threading
    import time
    from asr_craft.train.trainer import _prefetch_device

    n_before = threading.active_count()
    gen = _prefetch_device(iter(range(100)), lambda x: x, depth=2)
    assert next(gen) == 0
    gen.close()                               # GeneratorExit -> finally
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before
