from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.nfw import NFW, NFW_ELLIPSE
from gigalens_tpu_torch.profiles.mass.shear import Shear
from gigalens_tpu_torch.profiles.mass.sie import SIE, SIS

__all__ = ["EPL", "NFW", "NFW_ELLIPSE", "SIE", "SIS", "Shear"]
