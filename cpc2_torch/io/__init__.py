"""Weight interchange with the JAX package, and checkpoints."""

from .checkpoint import (get_checkpoint_data, load_args,
                         load_torch_checkpoint, save_args, save_checkpoint,
                         save_logs)
from .from_jax import state_dict_from_jax

__all__ = ["get_checkpoint_data", "load_args", "load_torch_checkpoint",
           "save_args", "save_checkpoint", "save_logs", "state_dict_from_jax"]
