from gigalens_tpu_torch.profiles.light.gaussian import Gaussian, Moffat
from gigalens_tpu_torch.profiles.light.sersic import CoreSersic, Sersic, SersicEllipse
from gigalens_tpu_torch.profiles.light.shapelets import Shapelets

__all__ = ["CoreSersic", "Gaussian", "Moffat", "Sersic", "SersicEllipse", "Shapelets"]
