from repro_torch.data.synthetic import (
    TokenTask, classification_task, make_lm_batch, make_round_batch,
)

__all__ = ["TokenTask", "classification_task", "make_lm_batch",
           "make_round_batch"]
