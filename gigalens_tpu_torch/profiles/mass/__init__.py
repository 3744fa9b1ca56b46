from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.shear import Shear

__all__ = ["EPL", "Shear"]
