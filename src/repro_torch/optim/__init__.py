from repro_torch.optim.optimizers import (
    Optimizer, make_optimizer, sam_gradient, value_and_grad,
)

__all__ = ["Optimizer", "make_optimizer", "sam_gradient", "value_and_grad"]
