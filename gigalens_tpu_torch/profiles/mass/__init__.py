from gigalens_tpu_torch.profiles.mass.dpie import DPIE, DPIEP, DPIS
from gigalens_tpu_torch.profiles.mass.dpie_subhalo import DPIESubhalo, DPIESubhaloSeries
from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.hernquist import Hernquist, HernquistEllipse
from gigalens_tpu_torch.profiles.mass.multipole import Multipole
from gigalens_tpu_torch.profiles.mass.nfw import NFW, NFW_ELLIPSE, TNFW
from gigalens_tpu_torch.profiles.mass.point import MassSheet, PointMass
from gigalens_tpu_torch.profiles.mass.scaling import ScalingRelation
from gigalens_tpu_torch.profiles.mass.series import MassSeries, ScalingRelationSeries
from gigalens_tpu_torch.profiles.mass.shear import Shear
from gigalens_tpu_torch.profiles.mass.sie import NIE, SIE, SIS

__all__ = [
    "EPL",
    "SIE",
    "SIS",
    "NIE",
    "Shear",
    "NFW",
    "NFW_ELLIPSE",
    "TNFW",
    "DPIS",
    "DPIE",
    "DPIEP",
    "ScalingRelation",
    "MassSeries",
    "ScalingRelationSeries",
    "DPIESubhalo",
    "DPIESubhaloSeries",
    "PointMass",
    "MassSheet",
    "Hernquist",
    "HernquistEllipse",
    "Multipole",
]
