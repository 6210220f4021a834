"""paddle.batch: the minibatch reader decorator (port of
paddle_tpu/batch.py; reference: python/paddle/batch.py). It wraps a
sample generator into a batch generator; drop_last drops a short tail
batch; batch_size must be a positive int.
"""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if not isinstance(batch_size, int) or batch_size <= 0:
        raise ValueError(
            f"batch_size should be a positive int, got {batch_size!r}")

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
