from repro_torch.checkpoint.io import (
    load_pytree, load_train_state, save_pytree, save_train_state,
)

__all__ = ["load_pytree", "load_train_state", "save_pytree",
           "save_train_state"]
