"""The port's core/pipeline.py and data/prefetch.py on the CPU.

The cases of ``tests/test_pipeline.py`` (``DoubleBuffer``'s exception
propagation, sentinel handling, ``overlapped`` ordering under a slow
consumer) and of ``tests/test_core.py``'s overlapped-ingest tests, on the
port's ``DoubleBuffer`` and ``overlapped``; and ``device_prefetch`` with
``device="cpu"``.  The card's copy path is in ``tests/test_torch_cuda.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import DoubleBuffer, device_prefetch, overlapped


def test_empty_source_stops_immediately():
    buf = DoubleBuffer([])
    assert list(buf) == []
    with pytest.raises(StopIteration):
        next(buf)                                   # stays exhausted


def test_exception_in_source_surfaces_at_consumer():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("camera disconnected")

    buf = DoubleBuffer(bad())
    assert next(buf) == 1
    assert next(buf) == 2
    with pytest.raises(RuntimeError, match="camera disconnected"):
        next(buf)


def test_exception_in_transform_surfaces_at_consumer():
    def boom(x):
        if x == 3:
            raise ValueError("decode failed")
        return x * 10

    buf = DoubleBuffer(range(5), transform=boom)
    assert next(buf) == 0
    assert next(buf) == 10
    assert next(buf) == 20
    with pytest.raises(ValueError, match="decode failed"):
        next(buf)


def test_items_before_failure_are_delivered_in_order():
    """The good prefix must arrive intact even though the producer thread
    has already hit the error by the time the consumer reads."""
    def bad():
        yield from range(2)                         # depth-sized prefix
        raise KeyError("late")

    buf = DoubleBuffer(bad(), depth=2)
    time.sleep(0.05)                                # let the producer finish
    assert [next(buf), next(buf)] == [0, 1]
    with pytest.raises(KeyError):
        next(buf)


def test_overlapped_preserves_order_under_slow_consumer():
    produced_at = {}

    def src():
        for i in range(6):
            produced_at[i] = time.perf_counter()
            yield i

    got = []
    consume_started = time.perf_counter()
    for item in overlapped(src(), depth=2):
        time.sleep(0.02)                            # slow loop body
        got.append(item)
    assert got == list(range(6))                    # exact order
    # ingest genuinely overlapped the loop body: the producer ran ahead of
    # the consumer instead of waiting for each item to be consumed
    assert produced_at[2] < consume_started + 0.02 * 2


def test_overlapped_applies_transform_in_background_thread():
    main = threading.get_ident()
    seen_threads = []

    def tag(x):
        seen_threads.append(threading.get_ident())
        return x + 100

    assert list(overlapped(range(3), transform=tag)) == [100, 101, 102]
    assert all(t != main for t in seen_threads)


def test_overlapped_preserves_order_and_items():
    items = list(range(57))
    assert list(overlapped(iter(items), depth=3)) == items


def test_overlapped_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("ingest died")
    it = overlapped(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="ingest died"):
        for _ in it:
            pass


def test_overlap_actually_overlaps():
    """Wall time of consume+produce must be < serial sum."""
    def slow_src():
        for _ in range(6):
            time.sleep(0.03)
            yield 1

    t0 = time.perf_counter()
    for _ in overlapped(slow_src()):
        time.sleep(0.03)                 # consumer work
    dt = time.perf_counter() - t0
    assert dt < 6 * 0.06 * 0.95          # strictly better than serial


def test_device_prefetch_on_the_cpu_returns_the_batches():
    """``device="cpu"``: neither pinned nor copied; every batch (nested
    dicts, lists and tuples of numpy arrays, as ``lm_batches`` gives the
    reference's ``device_prefetch`` in ``tests/test_data.py``) arrives in
    order as tensors equal to its input."""
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 100, (2, 17)).astype(np.int32),
                "labels": rng.integers(0, 100, (2, 17)).astype(np.int32),
                "extra": [rng.random((3,)).astype(np.float32),
                          (rng.random((2, 2)).astype(np.float32),)]}
               for _ in range(4)]
    out = list(device_prefetch(iter(batches), device="cpu"))
    assert len(out) == 4
    for got, want in zip(out, batches):
        assert set(got) == set(want)
        for name in ("tokens", "labels"):
            assert isinstance(got[name], torch.Tensor)
            assert got[name].device.type == "cpu"
            assert not got[name].is_pinned()
            assert np.array_equal(got[name].numpy(), want[name])
        assert np.array_equal(got["extra"][0].numpy(), want["extra"][0])
        assert isinstance(got["extra"][1], tuple)
        assert np.array_equal(got["extra"][1][0].numpy(),
                              want["extra"][1][0])
