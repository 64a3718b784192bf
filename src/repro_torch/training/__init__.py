"""Training (PyTorch port of ``repro.training``): plain SGD so far."""
from repro_torch.training.optimizer import sgd_update

__all__ = ["sgd_update"]
