"""The train path of the port (counterpart of ``repro.training``): AdamW
(``optimizer``), the train-step factory (``train_loop``) and the synthetic
data stream (``data``)."""

from repro_torch.training.data import make_batch, synthetic_batches
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    adamw_update_,
)
from repro_torch.training.train_loop import make_loss_fn, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "make_batch",
    "make_loss_fn",
    "make_train_step",
    "synthetic_batches",
]
