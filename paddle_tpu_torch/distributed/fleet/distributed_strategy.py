"""DistributedStrategy (port of
paddle_tpu/distributed/fleet/distributed_strategy.py; reference:
distributed/fleet/base/distributed_strategy.py over
framework/distributed_strategy.proto:122).

The reference's field names and defaults (AMPConfig, ShardingConfig,
RecomputeConfig, PipelineConfig, hybrid_configs, ...); a dict assigned
to a config merges into it, as Paddle's setters do. The fields resolve
to the mesh degrees (`mesh_degrees`) and the ZeRO stage
(`sharding_stage`) that fleet.distributed_train_step builds its
parallel.ShardedTrainStep from (fleet_base.py).
"""
from __future__ import annotations

import copy


class DistributedStrategy:
    def __init__(self):
        # feature switches (proto field parity)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0,
            "decr_ratio": 0.5,
            "use_dynamic_loss_scaling": True,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "dtype": "bfloat16",
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {
            "sharding_degree": 1,
            "sharding_stage": 2,
            "segment_broadcast_MB": 32.0,
            "hybrid_dp": False,
            "offload": False,
        }
        self.pipeline = False
        self.pipeline_configs = {
            "accumulate_steps": 1,
            "micro_batch_size": 1,
            "schedule_mode": "1F1B",
        }
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sp_degree": 1,
        }
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005,
                             "epsilon": 0.0,
                             "exclude_from_weight_decay": []}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1, "begin_step": 1}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0}
        self.fp16_allreduce = False
        self.a_sync = False
        self.a_sync_configs = {"k_steps": -1}
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = True
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = False
        self.last_comm_group_size_MB = 1.0
        # execution/build strategy parity shells (no graph to rewrite)
        self.execution_strategy = {"num_threads": 1,
                                   "num_iteration_per_drop_scope": 10}
        self.build_strategy = {"enable_sequential_execution": False,
                               "fuse_elewise_add_act_ops": True,
                               "fuse_bn_act_ops": True,
                               "enable_auto_fusion": True}

    # paddle setters accept dicts; mirror that behavior via attribute access
    def __setattr__(self, k, v):
        cur = self.__dict__.get(k)
        if isinstance(cur, dict) and isinstance(v, dict):
            merged = dict(cur)
            merged.update(v)
            object.__setattr__(self, k, merged)
        else:
            object.__setattr__(self, k, v)

    def mesh_degrees(self):
        """Resolve strategy → mesh axis degrees."""
        h = self.hybrid_configs
        dp = int(h.get("dp_degree", 1))
        tp = int(h.get("mp_degree", 1))
        pp = int(h.get("pp_degree", 1))
        sp = int(h.get("sp_degree", 1))
        shard = int(self.sharding_configs.get("sharding_degree", 1)) \
            if self.sharding else int(h.get("sharding_degree", 1))
        if self.tensor_parallel:
            tp = max(tp, int(self.tensor_parallel_configs.get(
                "tensor_parallel_degree", 1)))
        return {"dp": dp, "tp": tp, "pp": pp, "sp": sp,
                "sharding": max(shard, 1)}

    def sharding_stage(self):
        from ...parallel.api import ShardingStage
        if not self.sharding:
            return ShardingStage.OFF
        return int(self.sharding_configs.get("sharding_stage", 2))

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        on = [k for k in ("amp", "recompute", "sharding", "pipeline",
                          "tensor_parallel", "gradient_merge", "lamb",
                          "lars", "localsgd", "dgc") if getattr(self, k)]
        return f"DistributedStrategy(enabled={on}, " \
               f"hybrid={self.hybrid_configs})"
