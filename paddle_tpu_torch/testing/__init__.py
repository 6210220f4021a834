"""Testing utilities of the port (port of paddle_tpu/testing/): the
declarative op-test harness (op_test.py) and the fault injectors.
op_bench.py and the lock witness wait for later slices.
"""
from .op_test import OpTestCase, numeric_grad, run_case  # noqa: F401
from .faults import (FaultInjector, ServingFaultInjector,  # noqa: F401
                     corrupt_checkpoint)
