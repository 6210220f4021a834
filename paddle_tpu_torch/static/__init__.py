"""paddle.static, the static graph (port of paddle_tpu/static/).

A Program records the ops that user code and layers run on static
Variables (static/program.py); the Executor replays them on the card or
the CPU (static/executor.py), with append_backward / gradients
(static/backward.py), the optimizers' static minimize, static.nn's
layer functions and control flow, static.amp, save / load and the
inference artifact (static/io.py), the proto wire format
(static/proto_io.py), the RNN shims and py_reader, Print / Assert and
the long tail of static/compat.py.

Left out here: auc (the port has no batch-AUC op; paddle.metric.Auc
streams it), and the native datafeed behind Executor.train_from_dataset
(ROADMAP Queue 1 item 8).
"""
from .mode import (  # noqa: F401
    in_dynamic_mode, in_static_mode, enable_static, disable_static,
)
from .program import (  # noqa: F401
    Program, Block, Variable, OpDesc, program_guard,
    default_main_program, default_startup_program, data, create_parameter,
)
from .executor import Executor, Scope, global_scope  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from . import nn  # noqa: F401
from .nn import create_global_var  # noqa: F401
from .io import save, load, save_inference_model, load_inference_model  # noqa: F401
from ..jit import InputSpec  # noqa: F401


class CompiledProgram:
    """reference: compiler.py CompiledProgram: a handle the Executor
    unwraps (the port's Executor runs the program as recorded)."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy

    @property
    def _program_for_executor(self):
        return self.program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self


class ExecutionStrategy:
    num_threads = 1
    num_iteration_per_drop_scope = 100


class BuildStrategy:
    """reference: ParallelExecutor BuildStrategy's knobs, kept as
    attributes (the port's Executor has no graph passes to toggle)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    reduce_strategy = ReduceStrategy.AllReduce
    fuse_all_optimizer_ops = True
    fuse_elewise_add_act_ops = True
    enable_inplace = True


from .debug_ops import Print, Assert  # noqa: F401,E402
from .rnn_shims import (StaticRNN, DynamicRNN, py_reader,  # noqa: F401,E402
                        read_file)
from . import amp  # noqa: F401,E402
from .compat import (  # noqa: F401,E402
    name_scope, scope_guard, device_guard, cpu_places, cuda_places,
    xpu_places, save_vars, load_vars, save_to_file, load_from_file,
    serialize_persistables, deserialize_persistables, load_program_state,
    set_program_state, ParallelExecutor, WeightNormParamAttr,
)
from ..metric.metrics import accuracy  # noqa: F401,E402
from ..ops.extra_ops import py_func  # noqa: F401,E402
from .io import serialize_program, deserialize_program  # noqa: F401,E402
