from gigalens_tpu_torch.prob import bijectors, distributions
from gigalens_tpu_torch.prob.prior import Prior

__all__ = ["bijectors", "distributions", "Prior"]
