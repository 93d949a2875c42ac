"""The port's ``prefetch_iter`` (``repro_torch/data/pipeline.py``) against
the reference's failure contract (``tests/test_pipeline.py``): every item in
order, as the reference's yields them; a producer's exception re-raised at
the consumer (not a consumer blocked on an empty queue); an abandoned
iterator (``close()``, garbage collection) unblocking the worker's bounded
``put``.  ``TokenPipeline``: ``host_batch`` bit-equal to the reference's, and the
cases of ``tests/test_pipeline.py`` that drive its prefetch; a
``prefetch.read`` fault retried in the worker."""
import threading
import time

import numpy as np
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


# -- TokenPipeline (tests/test_pipeline.py's cases) ----------------------------


def _cfg():
    from repro_torch.configs.base import get_arch

    return get_arch("qwen3-0.6b").reduced()


def test_token_pipeline_host_batch_matches_reference():
    from repro.configs.base import get_arch as jget_arch
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro_torch.data.pipeline import TokenPipeline

    cfg, jcfg = _cfg(), jget_arch("qwen3-0.6b").reduced()
    assert cfg.vocab == jcfg.vocab
    for seed, batch, seq in ((0, 2, 8), (3, 4, 16), (7, 1, 33)):
        pipe = TokenPipeline(cfg, batch=batch, seq_len=seq, seed=seed)
        jpipe = JTokenPipeline(jcfg, batch=batch, seq_len=seq, seed=seed)
        for step in (0, 1, 5, 1234):
            got, want = pipe.host_batch(step), jpipe.host_batch(step)
            for k in ("inputs", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].shape == want[k].shape == (batch, seq)
                assert got[k].tobytes() == want[k].tobytes()


def test_token_pipeline_prefetch_matches_direct():
    import torch

    from repro_torch.data.pipeline import TokenPipeline

    pipe = TokenPipeline(_cfg(), batch=2, seq_len=8, seed=3)
    direct = [pipe.host_batch(s) for s in range(4)]
    got = list(pipe.prefetch(0, 4, torch.device("cpu")))
    assert [s for s, _ in got] == [0, 1, 2, 3]
    for (s, b), ref in zip(got, direct):
        assert b["inputs"].dtype == torch.int32 and b["inputs"].device.type == "cpu"
        np.testing.assert_array_equal(b["inputs"].numpy(), ref["inputs"])
        np.testing.assert_array_equal(b["labels"].numpy(), ref["labels"])
    assert _wait_no_prefetch_threads()


def test_prefetch_deterministic_across_restart():
    import torch

    from repro_torch.data.pipeline import TokenPipeline

    a = TokenPipeline(_cfg(), batch=2, seq_len=8, seed=7)
    b = TokenPipeline(_cfg(), batch=2, seq_len=8, seed=7)
    dev = torch.device("cpu")
    for (sa, ba), (sb, bb) in zip(a.prefetch(5, 3, dev), b.prefetch(5, 3, dev)):
        assert sa == sb
        assert torch.equal(ba["inputs"], bb["inputs"])


def test_prefetch_read_fault_is_retried_in_the_worker():
    from repro_torch.core import faults

    faults.reset(env=False)
    try:
        faults.configure("prefetch.read", at=2)
        got = list(prefetch_iter(lambda i: i * 3, range(5)))
        assert got == [(i, i * 3) for i in range(5)]
        snap = faults.snapshot()
        assert snap["balanced"] and snap["dispositions"]["retried"] == 1
        assert snap["hits"]["prefetch.read"] == 6
        faults.reset(env=False)
        faults.configure("prefetch.read", at=3, fatal=True)
        with pytest.raises(faults.FatalFault):
            list(prefetch_iter(lambda i: i, range(5)))
        assert faults.snapshot()["dispositions"]["fatal"] == 1
        assert _wait_no_prefetch_threads()
    finally:
        faults.reset(env=False)
