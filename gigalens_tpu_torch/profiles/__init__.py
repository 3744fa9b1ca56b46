from gigalens_tpu_torch.profiles.base import (
    LightProfile,
    MassProfile,
    Parameterized,
)

__all__ = ["LightProfile", "MassProfile", "Parameterized"]
