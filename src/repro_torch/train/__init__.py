# Training substrate (counterpart of repro.train): AdamW, schedules and
# the train-step factory.
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm, \
    adamw_state_specs
from .schedule import linear_warmup_cosine, constant
from .loop import make_train_step, train_loop

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "adamw_state_specs", "linear_warmup_cosine", "constant",
           "make_train_step", "train_loop"]
