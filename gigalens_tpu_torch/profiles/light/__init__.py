from gigalens_tpu_torch.profiles.light.sersic import Sersic, SersicEllipse

__all__ = ["Sersic", "SersicEllipse"]
