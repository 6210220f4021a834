"""fleet.data_generator: author MultiSlot datasets (port of
paddle_tpu/distributed/fleet/data_generator.py; reference:
python/paddle/distributed/fleet/data_generator/data_generator.py).

A user subclasses DataGenerator and implements generate_sample(line),
returning an iterator of samples, each [(slot_name, [values...]), ...];
run_from_stdin / run_from_memory / run_to_file serialise them into the
MultiSlot text protocol (`<n> v1 ... vn` per slot, one sample a line),
byte for byte the JAX package's. Its native consumer,
io/dataset_native.py (InMemoryDataset, QueueDataset), waits for slice
10; the files this writes are the same either way.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Subclass and implement generate_sample(line) returning an iterator
    of samples; each sample is [(slot_name, [values...]), ...] (the
    reference contract)."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    # -- user hooks ------------------------------------------------------
    def generate_sample(self, line):
        raise NotImplementedError(
            "implement generate_sample(line) -> iterator of "
            "[(slot_name, [values]), ...]")

    def generate_batch(self, samples):
        """Optional batch-level hook (reference: local_iter pass-through)."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- serialization ---------------------------------------------------
    def _gen_str(self, userline) -> str:
        """One sample → one MultiSlot text line (reference
        MultiSlotDataGenerator._gen_str)."""
        parts: List[str] = []
        for name, values in userline:
            if not isinstance(values, (list, tuple)):
                values = [values]
            if len(values) == 0:
                raise ValueError(
                    f"slot '{name}' has no values; every slot needs at "
                    "least one (reference _gen_str same check)")
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts) + "\n"

    def _slot_order_check(self, sample):
        names = [n for n, _ in sample]
        if self._proto_info is None:
            self._proto_info = names
        elif names != self._proto_info:
            raise ValueError(
                f"slot order changed between samples: {self._proto_info} "
                f"vs {names} (the MultiSlot protocol is positional)")

    # -- drivers ---------------------------------------------------------
    def _emit(self, samples_iter, write):
        """Drive generate_batch over batch_size_-sized groups, then
        serialize (the reference's local_iter/batch flow)."""
        pending = []
        def flush():
            for sample in self.generate_batch(list(pending))():
                self._slot_order_check(sample)
                write(self._gen_str(sample))
            pending.clear()
        for sample in samples_iter:
            pending.append(sample)
            if len(pending) >= self.batch_size_:
                flush()
        if pending:
            flush()

    def _samples_from_lines(self, lines):
        for line in lines:
            gen = self.generate_sample(line)
            if gen is None:
                continue
            yield from gen()

    def run_from_stdin(self):
        """stdin lines → stdout MultiSlot lines (the reference's Hadoop
        streaming entry point)."""
        self._emit(self._samples_from_lines(sys.stdin), sys.stdout.write)

    def run_from_memory(self, out=None):
        """Samples from generate_sample(None); returns the text (or writes
        to `out`)."""
        chunks = []
        self._emit(self.generate_sample(None)(), chunks.append)
        text = "".join(chunks)
        if out is not None:
            out.write(text)
        return text

    def run_to_file(self, lines: Iterable[str], path: str):
        """Convenience: transform input lines into a MultiSlot data file
        consumable by InMemoryDataset/QueueDataset.set_filelist."""
        with open(path, "w") as f:
            self._emit(self._samples_from_lines(lines), f.write)
        return path

    def slots(self) -> List[str]:
        """Slot names seen (after at least one sample was generated)."""
        return list(self._proto_info or [])


class MultiSlotDataGenerator(DataGenerator):
    """reference: MultiSlotDataGenerator — numeric slots."""


class MultiSlotStringDataGenerator(DataGenerator):
    """reference: MultiSlotStringDataGenerator — values kept as strings
    (ids arrive pre-tokenized)."""
