from gigalens_tpu_torch.inference.hmc import HMCResult, fit_hmc, sample_hmc
from gigalens_tpu_torch.inference.map import best_start, fit_map, laplace_scale_tril
from gigalens_tpu_torch.inference.sequence import ModellingSequence
from gigalens_tpu_torch.inference.smc import SMCResult, fit_smc
from gigalens_tpu_torch.inference.svi import fit_svi, importance_evidence

__all__ = ["ModellingSequence", "fit_map", "best_start", "laplace_scale_tril", "fit_svi",
           "importance_evidence", "fit_hmc", "sample_hmc", "HMCResult", "fit_smc",
           "SMCResult"]
