"""Parameter-server mode: host tables and RPC workers (port of
paddle_tpu/distributed/ps/; reference: paddle/fluid/distributed/ pscore,
the brpc PS service, its dense / sparse / geo tables and the async
communicator, with fleet/runtime/the_one_ps.py's server and worker
glue).

- tables: DenseTable / SparseTable (numpy host storage, sgd / adagrad /
  sum rules, lazily created sparse rows);
- transport: length-prefixed pickle over TCP, the JAX package's wire
  format (a port client and a JAX server interoperate, and the other way
  round);
- modes: sync push, and the geo-async GeoWorker (k local steps, then a
  delta push);
- DeviceEmbeddingCache: the hot rows on the card, updated there, the
  cold tail over the PS.
"""
from .table import DenseTable, SparseTable  # noqa: F401
from .server import ParameterServer  # noqa: F401
from .client import PsClient  # noqa: F401
from .device_cache import DeviceEmbeddingCache  # noqa: F401

__all__ = ["DenseTable", "SparseTable", "ParameterServer", "PsClient",
           "DeviceEmbeddingCache"]
