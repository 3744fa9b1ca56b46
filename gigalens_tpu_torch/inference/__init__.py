from gigalens_tpu_torch.inference.map import best_start, fit_map
from gigalens_tpu_torch.inference.sequence import ModellingSequence

__all__ = ["ModellingSequence", "fit_map", "best_start"]
