"""Fleet: the user-facing distributed API (port of
paddle_tpu/distributed/fleet/fleet_base.py; reference:
distributed/fleet/base/fleet_base.py:63).

`fleet.init(is_collective=True, strategy)` joins the process group
(init_parallel_env) and sets the global mesh from the strategy's
degrees (hybrid_configs dp/mp, sharding_degree; all 1 means dp over
every rank; degrees that do not multiply to the world size rescale dp,
with a warning, as in the JAX package). The worker queries read the
role maker; `barrier_worker` is a barrier over the world.

`distributed_train_step(model, loss_fn, optimizer, strategy)` composes
the strategy into one parallel.ShardedTrainStep, as the reference's
meta-optimizer pipeline composes one program:
- lamb / lars substitute the optimizer (distributed_optimizer does too);
- recompute wraps the loss function (finer segments: fleet.utils.
  recompute inside the model, or GPTConfig.use_recompute);
- amp O1 runs the loss under auto_cast; amp O2 (use_pure_fp16) decorates
  the model and optimizer (bf16 parameters, f32 masters), the
  reference's pure-fp16 meta-optimizer (the JAX package wraps the loss
  in auto_cast O2 instead, which on a decorated model of the port would
  also keep the black-list ops and the residual stream in f32);
- sharding becomes the ZeRO stage, hybrid degrees the mesh;
- gradient_merge becomes the step's grad_accum_steps: k calls apply one
  update from the mean of their gradients (the JAX package's
  _GradientMergeStep applies an update every call);
- pipeline, on a pipeline container (parallel/pipeline.py's
  PipelinedGPT or PipelineLayer), sets its microbatch count from
  pipeline_configs' accumulate_steps (when above 1; the JAX package
  leaves the count at the pp degree) and takes recompute as the
  container's own per-layer remat rather than a checkpoint around the
  whole loss; hybrid_configs' pp_degree and sp_degree reach the mesh;
- localsgd / adaptive_localsgd, dgc and fp16_allreduce build
  fleet/comm_opt.py's steps instead of ShardedTrainStep, over a pure dp
  mesh; their conflicts (with each other, and with tp, pp, sp or
  sharding degrees above 1) raise as in the JAX package.
The parameter-server methods (`init_server`, `run_server`,
`init_worker`, `stop_worker`) drive distributed/ps, as the JAX
package's do (fleet_base.py:207-245).
"""
from __future__ import annotations

import warnings
from typing import Optional

from ...parallel import mesh as _mesh
from ...parallel.api import ShardedTrainStep
from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase

__all__ = ["Fleet"]


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._is_collective = True
        self._runtime_handle = None
        self._util = None
        self._origin_optimizer = None
        self._hybrid_mesh = None

    # ----------------------------------------------------------------- init
    def init(self, role_maker=None, is_collective=False, strategy=None):
        """reference: fleet_base.py:130."""
        from ..parallel import init_parallel_env
        self._is_collective = is_collective or role_maker is None
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=self._is_collective)
        self._user_defined_strategy = strategy or DistributedStrategy()
        init_parallel_env()
        degrees = self._user_defined_strategy.mesh_degrees()
        n_dev = _mesh.world_size()
        want = 1
        for v in degrees.values():
            want *= v
        if want == 1:
            degrees["dp"] = n_dev  # pure DP over every rank by default
        elif want != n_dev:
            warnings.warn(
                f"strategy degrees {degrees} != {n_dev} devices; scaling dp")
            rest = want // max(degrees["dp"], 1)
            if n_dev % rest == 0:
                degrees["dp"] = n_dev // rest
        try:
            self._hybrid_mesh = _mesh.build_mesh(**degrees)
            _mesh.set_global_mesh(self._hybrid_mesh)
        except _mesh.TopologyError as e:
            warnings.warn(str(e))
            self._hybrid_mesh = _mesh.get_global_mesh()
        return self

    # ------------------------------------------------------------- identity
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def server_num(self):
        return self._role_maker.server_num()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from .. import collective
        collective.barrier()

    # ------------------------------------------------------------ wrappers
    def distributed_model(self, model):
        """reference: fleet_base.py distributed_model -> DataParallel."""
        from ..parallel import DataParallel
        if isinstance(model, DataParallel):
            return model
        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        """reference: fleet_base.py:594: the optimizer under the strategy
        (lamb/lars substituted; amp adds a GradScaler to minimize)."""
        if strategy is not None:
            self._user_defined_strategy = strategy
        self._origin_optimizer = optimizer
        self.user_defined_optimizer = optimizer
        return _FleetOptimizer(self, optimizer,
                               self._user_defined_strategy)

    def distributed_train_step(self, model, loss_fn, optimizer=None,
                               strategy=None):
        """The composed distributed train step (module docstring)."""
        strategy = strategy or self._user_defined_strategy
        optimizer = optimizer or self._origin_optimizer
        _check_unsupported(strategy)
        real_model = model._layers if hasattr(model, "_layers") else model
        opt = _apply_optimizer_strategies(optimizer, strategy)
        cfg = strategy.amp_configs
        if strategy.amp and cfg.get("use_pure_fp16"):
            from ... import amp
            amp.decorate(real_model, opt, level="O2",
                         dtype=cfg.get("dtype", "bfloat16"))
        pipelined = strategy.pipeline and hasattr(real_model, "num_micro")
        if pipelined:
            micro = int(strategy.pipeline_configs.get("accumulate_steps", 1))
            if micro > 1:
                real_model.num_micro = micro
        inner_loss_fn = _apply_loss_strategies(loss_fn, strategy,
                                               pipelined=pipelined)
        if strategy.localsgd or strategy.adaptive_localsgd:
            from .comm_opt import AdaptiveLocalSGDStep, LocalSGDStep
            if strategy.fp16_allreduce:
                raise NotImplementedError(
                    "localsgd + fp16_allreduce cannot compose: LocalSGD "
                    "does not allreduce gradients at all (it syncs params "
                    "every k steps); pick one.")
            self._pure_dp("localsgd runs per-rank parameter copies over a "
                          "pure dp mesh; combining it with tp/pp/sp/sharding "
                          "degrees is not supported (the reference's "
                          "localsgd_optimizer is DP-only too).")
            cfg = strategy.localsgd_configs
            if strategy.adaptive_localsgd:
                acfg = strategy.adaptive_localsgd_configs
                return AdaptiveLocalSGDStep(
                    real_model, inner_loss_fn, opt,
                    init_k_steps=int(acfg.get("init_k_steps", 1)),
                    begin_step=int(acfg.get("begin_step", 1)))
            return LocalSGDStep(real_model, inner_loss_fn, opt,
                                k_steps=int(cfg.get("k_steps", 1)),
                                begin_step=int(cfg.get("begin_step", 1)))
        if strategy.dgc:
            from .comm_opt import DGCStep
            self._pure_dp("dgc runs per-rank gradient state over a pure dp "
                          "mesh; tp/pp/sp/sharding degrees do not compose "
                          "(the reference's dgc_optimizer is "
                          "DP-collective-only too).")
            cfg = strategy.dgc_configs
            return DGCStep(
                real_model, inner_loss_fn, opt,
                rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
                rampup_step=int(cfg.get("rampup_step", 1)),
                sparsity=cfg.get("sparsity", [0.999]))
        if strategy.fp16_allreduce:
            from .comm_opt import Fp16AllReduceStep
            self._pure_dp("fp16_allreduce's reduced-precision gradient sync "
                          "runs over a pure dp mesh; with tp/pp/sp/sharding "
                          "degrees use ShardedTrainStep instead.")
            return Fp16AllReduceStep(real_model, inner_loss_fn, opt)
        k = int(strategy.gradient_merge_configs["k_steps"]) \
            if strategy.gradient_merge else 1
        return ShardedTrainStep(
            real_model, inner_loss_fn, opt,
            mesh=self._hybrid_mesh, sharding_stage=strategy.sharding_stage(),
            grad_accum_steps=k)

    def _pure_dp(self, message: str) -> None:
        if self._hybrid_mesh is not None and any(
                self._hybrid_mesh.shape.get(ax, 1) > 1
                for ax in ("tp", "pp", "sp", "sharding")):
            raise NotImplementedError(message)

    # --------------------------------------------------------------- state
    def state_dict(self):
        return self._origin_optimizer.state_dict() \
            if self._origin_optimizer else {}

    def save_persistables(self, exe=None, dirname=None, main_program=None,
                          mode=0):
        from ... import framework_io
        if dirname and self._origin_optimizer:
            framework_io.save(self.state_dict(), dirname + "/fleet.pdopt")

    # -------------------------------------------------- parameter server
    # reference: fleet_base.py init_server/run_server/init_worker/
    # stop_worker driving the_one_ps.py; here distributed/ps
    def init_server(self, *args, dense_tables=None, sparse_tables=None,
                    host="127.0.0.1", port=0, **kwargs):
        """Create the server and its tables. dense_tables:
        {table_id: dict(shape=..., optimizer='sgd', lr=...)};
        sparse_tables: {table_id: dict(dim=..., optimizer=..., lr=...)}."""
        from ..ps import ParameterServer
        self._ps_server = ParameterServer(host, port)
        for tid, spec in (dense_tables or {}).items():
            self._ps_server.add_dense_table(tid, **spec)
        for tid, spec in (sparse_tables or {}).items():
            self._ps_server.add_sparse_table(tid, **spec)
        return self._ps_server

    def run_server(self, block: bool = False):
        if getattr(self, "_ps_server", None) is None:
            raise RuntimeError("call fleet.init_server(...) first")
        self._ps_server.start()
        if block:
            self._ps_server.join()
        return self._ps_server.endpoint

    def init_worker(self, endpoints=None):
        from ..ps import PsClient
        eps = endpoints
        if not eps and self._role_maker is not None:
            eps = self._role_maker.get_pserver_endpoints()
        if not eps:
            raise RuntimeError(
                "no pserver endpoints: pass init_worker(endpoints=[...]) "
                "or set PADDLE_PSERVERS_IP_PORT_LIST")
        self._ps_client = PsClient(list(eps))
        return self._ps_client

    def stop_worker(self):
        """reference: the_one_ps stop_worker: the workers meet at a
        barrier, then only the first one stops the servers (a shutdown
        by any worker would kill the PS under peers still training)."""
        client = getattr(self, "_ps_client", None)
        if client is not None:
            rm = self._role_maker
            world = rm.worker_num() if rm is not None else 1
            if world > 1:
                client.barrier(world)
            if rm is None or rm.is_first_worker():
                client.stop_server()
            client.close()
            self._ps_client = None


class _FleetOptimizer:
    """The wrapped optimizer returned by fleet.distributed_optimizer
    (reference: Fleet as optimizer proxy with minimize at
    fleet_base.py:1066)."""

    def __init__(self, fleet, inner, strategy):
        self._fleet = fleet
        self._inner = _apply_optimizer_strategies(inner, strategy)
        self._strategy = strategy
        self._scaler = None
        if strategy.amp:
            from ...amp import GradScaler
            cfg = strategy.amp_configs
            self._scaler = GradScaler(
                init_loss_scaling=cfg["init_loss_scaling"],
                incr_ratio=cfg["incr_ratio"],
                decr_ratio=cfg["decr_ratio"],
                incr_every_n_steps=cfg["incr_every_n_steps"],
                decr_every_n_nan_or_inf=cfg["decr_every_n_nan_or_inf"],
                use_dynamic_loss_scaling=cfg["use_dynamic_loss_scaling"])

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if self._scaler is not None:
            self._scaler.scale(loss).backward()
            self._scaler.step(self._inner)
            self._scaler.update()
        else:
            loss.backward()
            self._inner.step()
        return None, [(p, p.grad)
                      for p in (self._inner._parameter_list or [])]

    def step(self):
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()


def _check_unsupported(strategy: DistributedStrategy):
    """Pairs of flags that cannot compose raise, as in the JAX package."""
    if strategy.dgc and (strategy.localsgd or strategy.adaptive_localsgd):
        raise NotImplementedError(
            "dgc + localsgd cannot compose: LocalSGD does not communicate "
            "gradients at all, so there is nothing to compress.")
    if strategy.dgc and strategy.fp16_allreduce:
        raise NotImplementedError(
            "dgc + fp16_allreduce cannot compose: DGC replaces the dense "
            "gradient allreduce with top-k sparsified sync.")


def _apply_optimizer_strategies(optimizer, strategy: DistributedStrategy):
    """lars/lamb substitute the base optimizer (reference:
    fleet/meta_optimizers/lars_optimizer.py, lamb_optimizer.py)."""
    from ...optimizer import Lamb, Lars, Momentum
    if optimizer is None:
        return None
    if strategy.lamb:
        cfg = strategy.lamb_configs
        return Lamb(learning_rate=optimizer._learning_rate,
                    lamb_weight_decay=cfg["lamb_weight_decay"],
                    parameters=optimizer._parameter_list,
                    grad_clip=optimizer._grad_clip)
    if strategy.lars and isinstance(optimizer, Momentum):
        cfg = strategy.lars_configs
        return Lars(learning_rate=optimizer._learning_rate,
                    momentum=optimizer._momentum,
                    lars_coeff=cfg["lars_coeff"],
                    lars_weight_decay=cfg["lars_weight_decay"],
                    parameters=optimizer._parameter_list,
                    grad_clip=optimizer._grad_clip)
    return optimizer


def _apply_loss_strategies(loss_fn, strategy: DistributedStrategy,
                           pipelined: bool = False):
    """recompute and amp O1 wrap the loss computation (reference:
    recompute_optimizer.py, amp_optimizer.py); O2 is the decorated
    model's (distributed_train_step), and a pipeline container's
    recompute its own per-layer remat."""
    fn = loss_fn
    if strategy.recompute and not pipelined:
        from .utils import recompute

        def recompute_fn(model, *args, _fn=fn):
            return recompute(_fn, model, *args)
        fn = recompute_fn
    cfg = strategy.amp_configs
    if strategy.amp and not cfg.get("use_pure_fp16"):
        from ...amp import auto_cast

        def amp_fn(model, *args, _fn=fn):
            with auto_cast(level="O1", dtype=cfg.get("dtype", "bfloat16"),
                           custom_white_list=cfg.get("custom_white_list"),
                           custom_black_list=cfg.get("custom_black_list")):
                return _fn(model, *args)
        fn = amp_fn
    return fn
