# Distribution runtime (counterpart of repro.distrib): sharding rules,
# checkpointing (with the elastic restore onto a DeviceMesh), gradient
# compression and fault tolerance.
from .shardings import (ShardingRules, DEFAULT_RULES, spec_for,
                        tree_shardings, batch_axes, describe_tree_shardings)
from .checkpoint import (Checkpointer, save_checkpoint, restore_checkpoint,
                         latest_step)
from .compression import CompressionConfig, init_ef_state, compress_grads, \
    wire_bytes
from .fault import (Preemption, RestartableLoop, RetryPolicy,
                    StragglerPolicy)

__all__ = ["ShardingRules", "DEFAULT_RULES", "spec_for", "tree_shardings",
           "batch_axes", "describe_tree_shardings", "Checkpointer",
           "save_checkpoint", "restore_checkpoint", "latest_step",
           "CompressionConfig", "init_ef_state", "compress_grads",
           "wire_bytes", "RestartableLoop", "RetryPolicy", "StragglerPolicy",
           "Preemption"]
