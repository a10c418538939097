"""Training substrate: AdamW, the train step, checkpointing."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,  # noqa: F401
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step  # noqa: F401
from repro_torch.train import checkpoint  # noqa: F401
