from gigalens_tpu_torch.inference.hmc import HMCResult, fit_hmc, sample_hmc
from gigalens_tpu_torch.inference.map import best_start, fit_map, laplace_scale_tril
from gigalens_tpu_torch.inference.sequence import ModellingSequence
from gigalens_tpu_torch.inference.svi import fit_svi

__all__ = ["ModellingSequence", "fit_map", "best_start", "laplace_scale_tril", "fit_svi",
           "fit_hmc", "sample_hmc", "HMCResult"]
