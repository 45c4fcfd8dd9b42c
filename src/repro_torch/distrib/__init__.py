# Distribution runtime (counterpart of repro.distrib): checkpointing and
# fault tolerance.  The reference's shardings and gradient compression
# come with the port's distribution layer.
from .checkpoint import (Checkpointer, save_checkpoint, restore_checkpoint,
                         latest_step)
from .fault import (Preemption, RestartableLoop, RetryPolicy,
                    StragglerPolicy)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "RestartableLoop", "RetryPolicy",
           "StragglerPolicy", "Preemption"]
