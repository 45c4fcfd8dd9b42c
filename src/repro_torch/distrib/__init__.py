# Distribution runtime (counterpart of repro.distrib): checkpointing,
# gradient compression and fault tolerance.  The reference's shardings
# come with the port's distribution layer (meshes).
from .checkpoint import (Checkpointer, save_checkpoint, restore_checkpoint,
                         latest_step)
from .compression import CompressionConfig, init_ef_state, compress_grads, \
    wire_bytes
from .fault import (Preemption, RestartableLoop, RetryPolicy,
                    StragglerPolicy)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "CompressionConfig", "init_ef_state",
           "compress_grads", "wire_bytes", "RestartableLoop", "RetryPolicy",
           "StragglerPolicy", "Preemption"]
