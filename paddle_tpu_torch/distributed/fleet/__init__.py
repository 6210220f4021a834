"""paddle.distributed.fleet (port of paddle_tpu/distributed/fleet/):
the `fleet` singleton and its module-level methods (fleet_base.py, the
parameter-server methods included), the DistributedStrategy, the role
makers, `utils` (recompute), `comm_opt` (LocalSGD, adaptive LocalSGD,
DGC, fp16_allreduce), `data_generator` and `metrics`.
"""
from .fleet_base import Fleet, _FleetOptimizer  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, UserDefinedRoleMaker, RoleMakerBase, Role,
)
from . import utils  # noqa: F401
from .utils import recompute  # noqa: F401

fleet = Fleet()

init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_train_step = fleet.distributed_train_step
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
is_worker = fleet.is_worker
is_server = fleet.is_server
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
save_persistables = fleet.save_persistables
from . import comm_opt  # noqa: F401
from . import data_generator  # noqa: F401
from .data_generator import (  # noqa: F401
    DataGenerator, MultiSlotDataGenerator, MultiSlotStringDataGenerator,
)
from . import metrics  # noqa: F401

__all__ = ["Fleet", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "RoleMakerBase", "Role", "utils",
           "recompute", "fleet", "init", "distributed_model",
           "distributed_optimizer", "distributed_train_step",
           "worker_index", "worker_num", "is_first_worker", "is_worker",
           "is_server", "barrier_worker", "init_worker", "init_server",
           "run_server", "stop_worker", "save_persistables", "comm_opt",
           "data_generator", "DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator", "metrics"]
