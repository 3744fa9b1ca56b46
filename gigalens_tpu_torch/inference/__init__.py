from gigalens_tpu_torch.inference.hmc import HMCResult, fit_hmc, sample_hmc
from gigalens_tpu_torch.inference.map import (
    best_start, fit_map, laplace_scale_tril, laplace_scale_trils_survey,
)
from gigalens_tpu_torch.inference.sequence import ModellingSequence
from gigalens_tpu_torch.inference.smc import SMCResult, fit_smc
from gigalens_tpu_torch.inference.survey import SurveySequence
from gigalens_tpu_torch.inference.svi import (
    fit_svi, fit_svi_survey, importance_evidence, importance_evidence_survey,
)

__all__ = ["ModellingSequence", "SurveySequence", "fit_map", "best_start",
           "laplace_scale_tril", "laplace_scale_trils_survey", "fit_svi", "fit_svi_survey",
           "importance_evidence", "importance_evidence_survey", "fit_hmc", "sample_hmc",
           "HMCResult", "fit_smc", "SMCResult"]
