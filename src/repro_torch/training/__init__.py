"""Training substrate (PyTorch port of ``repro.training``): optimizer,
train step, checkpointing."""
from repro_torch.training.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, clip_by_global_norm, global_norm,
    lr_at, sgd_update,
)
from repro_torch.training.train_loop import (
    TrainState, cross_entropy_chunked, init_train_state, lm_loss, loss_and_grads,
    make_train_step,
)

__all__ = [
    "AdamWConfig", "AdamWState", "TrainState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "cross_entropy_chunked", "global_norm", "init_train_state",
    "latest_checkpoint", "lm_loss", "loss_and_grads", "lr_at", "make_train_step",
    "restore_checkpoint", "save_checkpoint", "sgd_update",
]
