"""paddle.utils, in part (port of paddle_tpu/utils/__init__.py:58-104):
`unique_name`, the process-wide name uniquifier, with the `guard` that
scopes its counters, the Layers' name counters and the Tensors' name
counter, so a model rebuilt inside a fresh guard gets the same
generated names (static programs are rebuilt so to load a checkpoint).

Left out: deprecated, try_import, run_check, download, flops, crypto,
profiler, cpp_extension, load_op_library, require_version and
OpLastCheckpointChecker (ROADMAP Queue 1).
"""
from __future__ import annotations

import contextlib

__all__ = ["unique_name"]


class _UniqueNameGenerator:
    def __init__(self):
        self._ids = {}

    def __call__(self, prefix: str) -> str:
        i = self._ids.get(prefix, 0)
        self._ids[prefix] = i + 1
        return f"{prefix}_{i}"


class unique_name:
    """reference: fluid/unique_name.py."""
    _generator = _UniqueNameGenerator()

    @staticmethod
    def generate(prefix: str) -> str:
        return unique_name._generator(prefix)

    @staticmethod
    def switch(new_generator=None):
        old = unique_name._generator
        unique_name._generator = new_generator or _UniqueNameGenerator()
        return old

    @staticmethod
    def guard(new_generator=None):
        @contextlib.contextmanager
        def _guard():
            from ..core import tensor as _tensor
            from ..nn.layer import layers as _layers
            old_gen = unique_name.switch(new_generator)
            old_layer = dict(_layers._layer_name_counters)
            old_tensor = _tensor._tensor_name_counter[0]
            _layers._layer_name_counters.clear()
            _tensor._tensor_name_counter[0] = 0
            try:
                yield
            finally:
                unique_name._generator = old_gen
                _layers._layer_name_counters.clear()
                _layers._layer_name_counters.update(old_layer)
                _tensor._tensor_name_counter[0] = old_tensor
        return _guard()
