"""paddle.reader: the generator-composition decorators (port of
paddle_tpu/reader/__init__.py; reference: python/paddle/reader/
decorator.py). Host Python, the JAX package's code: threads for
buffered, xmap_readers and multiprocess_reader, and shuffle on Python's
`random` stream, so a seeded `random` gives the JAX package's order.
"""
from __future__ import annotations

import itertools
import queue
import random as _py_random
from threading import Thread

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "ComposeNotAligned", "firstn", "xmap_readers",
           "multiprocess_reader"]


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Materialise once, replay from memory on every call."""
    all_data = tuple(reader())

    def rd():
        yield from all_data
    return rd


def map_readers(func, *readers):
    """Element-wise func over the zip of readers."""
    def rd():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)
    return rd


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of buf_size samples."""
    def rd():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _py_random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _py_random.shuffle(buf)
            yield from buf
    return rd


def chain(*readers):
    """Concatenate readers back to back."""
    def rd():
        for r in readers:
            yield from r()
    return rd


def compose(*readers, **kwargs):
    """Zip readers into flat tuples; check_alignment (default True)
    raises ComposeNotAligned when one reader ends early."""
    check_alignment = kwargs.pop("check_alignment", True)

    def _tuplize(x):
        return x if isinstance(x, tuple) else (x,)

    def rd():
        its = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*its):
                yield sum((_tuplize(o) for o in outputs), ())
            return
        sentinel = object()
        for outputs in itertools.zip_longest(*its, fillvalue=sentinel):
            if sentinel in outputs:
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield sum((_tuplize(o) for o in outputs), ())
    return rd


def buffered(reader, size):
    """Decouple producer/consumer through a bounded queue fed by a
    thread (the reference's design)."""
    end = object()

    def rd():
        q = queue.Queue(maxsize=size)

        def feed():
            try:
                for e in reader():
                    q.put(e)
            finally:
                q.put(end)
        t = Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                break
            yield e
    return rd


def firstn(reader, n):
    def rd():
        yield from itertools.islice(reader(), n)
    return rd


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader through worker THREADS (the GIL is
    fine here: reference mappers are IO/numpy-bound), optionally
    order-preserving."""
    end = object()

    def rd():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, e in enumerate(reader()):
                in_q.put((i, e))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, e = item
                out_q.put((i, mapper(e)))

        Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            Thread(target=work, daemon=True).start()
        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
            return
        pending, want = {}, 0
        while finished < process_num or pending:
            if want in pending:
                yield pending.pop(want)
                want += 1
                continue
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            pending[item[0]] = item[1]
        while want in pending:
            yield pending.pop(want)
            want += 1
    return rd


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """reference decorator.py multiprocess_reader — here the readers run
    in threads (one host process; the reference used fork+pipe for
    GIL-bound python parsing, which the native C++ DataFeed replaces)."""
    def rd():
        merged = buffered(chain(*readers), queue_size)
        yield from merged()
    return rd
