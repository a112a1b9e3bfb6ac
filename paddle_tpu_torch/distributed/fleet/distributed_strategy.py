"""``DistributedStrategy`` (port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``; reference:
fleet/base/distributed_strategy.py:175).

A plain configuration object with the reference's knobs.  This slice
reads ``hybrid_configs`` (the degrees) in ``fleet.init``; the other
knobs are recorded and read by nothing yet.
"""

from __future__ import annotations

import copy

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "mp_configs": {"sync_param": False, "sync_grad": False,
                   "sync_moment": False, "mp_async_allreduce": False,
                   "mp_skip_c_identity": False,
                   "mp_fused_linear_param_grad_add": False,
                   "recompute_allgather": False},
    "pp_configs": {"micro_batch_size": 1, "accumulate_steps": 1,
                   "dp_comm_overlap": False, "sharding_comm_overlap": False,
                   "overlap_p2p_comm": True, "use_batch_p2p_comm": False,
                   "release_gradients": False, "schedule_mode": "1F1B"},
    "sharding_configs": {"tensor_fusion": False, "accumulate_steps": 1,
                         "comm_overlap": False, "split_param": False,
                         "use_reduce_avg": True, "stage": 1,
                         "offload": False},
}


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = copy.deepcopy(_DEFAULT_HYBRID)
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 2 ** 15,
                            "incr_every_n_steps": 1000,
                            "decr_every_n_nan_or_inf": 2,
                            "incr_ratio": 2.0, "decr_ratio": 0.5,
                            "use_dynamic_loss_scaling": True,
                            "custom_white_list": [],
                            "custom_black_list": [],
                            "use_pure_fp16": False, "use_fp16_guard": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.a_sync = False
        self.a_sync_configs = {}

    def __setattr__(self, key, value):
        # assigning hybrid_configs merges into the defaults, nested dicts
        # included (the reference's proto merge)
        if key == "hybrid_configs" and isinstance(value, dict) \
                and "hybrid_configs" in self.__dict__:
            merged = copy.deepcopy(self.__dict__["hybrid_configs"])
            for k, v in value.items():
                if isinstance(v, dict) and isinstance(merged.get(k), dict):
                    merged[k].update(v)
                else:
                    merged[k] = v
            self.__dict__["hybrid_configs"] = merged
            return
        self.__dict__[key] = value


__all__ = ["DistributedStrategy"]
