"""Testing utilities of the port (port of paddle_tpu/testing/).

Only the fault injectors are ported; the op-test harness (op_test.py,
op_bench.py) and the lock witness wait for later slices.
"""
from .faults import (FaultInjector, ServingFaultInjector,  # noqa: F401
                     corrupt_checkpoint)
