"""The port's ``prefetch_iter`` (``repro_torch/data/pipeline.py``) against
the reference's failure contract (``tests/test_pipeline.py``): every item in
order, as the reference's yields them; a producer's exception re-raised at
the consumer (not a consumer blocked on an empty queue); an abandoned
iterator (``close()``, garbage collection) unblocking the worker's bounded
``put``.  ``TokenPipeline`` waits for the LM-training slice."""
import threading
import time

import pytest

from repro.data.pipeline import prefetch_iter as jprefetch_iter
from repro_torch.data.pipeline import _PREFETCH_THREAD_NAME, prefetch_iter


def _live_prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == _PREFETCH_THREAD_NAME and t.is_alive()]


def _wait_no_prefetch_threads(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _live_prefetch_threads():
            return True
        time.sleep(0.02)
    return not _live_prefetch_threads()


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_yields_all_items_in_order(depth):
    got = list(prefetch_iter(lambda i: i * i, range(20), depth=depth))
    assert got == [(i, i * i) for i in range(20)]
    assert got == list(jprefetch_iter(lambda i: i * i, range(20), depth=depth))
    assert _wait_no_prefetch_threads()


def test_prefetch_worker_exception_propagates():
    def produce(i):
        if i == 3:
            raise ZeroDivisionError("synthetic producer crash")
        return i * 2

    got = []
    with pytest.raises(ZeroDivisionError, match="synthetic producer crash"):
        for _item, val in prefetch_iter(produce, range(10), depth=2):
            got.append(val)
    assert got == [0, 2, 4]  # everything before the crash was delivered
    assert _wait_no_prefetch_threads()


def test_prefetch_exception_on_first_item():
    def produce(i):
        raise RuntimeError("dead on arrival")

    with pytest.raises(RuntimeError, match="dead on arrival"):
        list(prefetch_iter(produce, range(4)))
    assert _wait_no_prefetch_threads()


def test_prefetch_early_abandon_does_not_wedge_worker():
    produced = []

    def produce(i):
        produced.append(i)
        return i

    it = prefetch_iter(produce, range(10_000), depth=2)
    for item, _ in it:
        if item >= 2:
            break
    it.close()  # the generator's finally: stop, join
    assert _wait_no_prefetch_threads()
    assert len(produced) < 100  # stopped long before the 10k items


def test_prefetch_abandon_via_gc():
    it = prefetch_iter(lambda i: i, range(10_000), depth=2)
    next(it)
    del it  # the generator's close runs its finally
    assert _wait_no_prefetch_threads()
