from repro_torch.models.registry import (
    ModelAPI, build_model, flat_from_numpy, params_from_numpy,
)

__all__ = ["ModelAPI", "build_model", "flat_from_numpy", "params_from_numpy"]
