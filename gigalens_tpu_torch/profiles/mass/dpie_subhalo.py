"""dPIE cluster-member (subhalo) populations, direct and series-accelerated
(port of :mod:`gigalens_tpu.profiles.mass.dpie_subhalo`). Default
Faber-Jackson-like scaling powers 0.5 on (theta_E, r_core, r_cut).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from gigalens_tpu_torch.profiles.mass.dpie import DPIE
from gigalens_tpu_torch.profiles.mass.scaling import ScalingRelation
from gigalens_tpu_torch.profiles.mass.series import ScalingRelationSeries

_DEFAULT_POWERS = {"theta_E": 0.5, "r_core": 0.5, "r_cut": 0.5}


class DPIESubhalo(ScalingRelation):
    """Direct sum of scaled dPIE members (exact, O(galaxies) a step)."""

    _params = ["theta_E", "r_core", "r_cut"]

    def __init__(
        self,
        lum_star: float,
        galaxy_catalogue: Dict[str, List],
        scaling_params_power: Optional[Dict[str, float]] = None,
        **kwargs,
    ):
        super().__init__(
            profile=DPIE(),
            scaling_params=["theta_E", "r_core", "r_cut"],
            lum_star=lum_star,
            scaling_params_power=scaling_params_power or dict(_DEFAULT_POWERS),
            galaxy_catalogue=galaxy_catalogue,
            **kwargs,
        )


class DPIESubhaloSeries(ScalingRelationSeries):
    """Taylor-in-r_cut dPIE members (O(order) a step after the precompute)."""

    _params = ["theta_E", "r_cut"]
    _constants = ["r_core", "center_x", "center_y", "e1", "e2"]
    _name = "Scaled-SeriesExpansion-dPIE"

    def __init__(
        self,
        lum_star: float,
        galaxy_catalogue: Dict[str, List],
        scaling_params_power: Optional[Dict[str, float]] = None,
        order: int = 3,
        chunk_size: Optional[int] = None,
    ):
        super().__init__(
            profile=DPIE(),
            series_param="r_cut",
            amplitude_param="theta_E",
            scaling_params=["theta_E", "r_core", "r_cut"],
            lum_star=lum_star,
            scaling_params_power=scaling_params_power or dict(_DEFAULT_POWERS),
            galaxy_catalogue=galaxy_catalogue,
            order=order,
            chunk_size=chunk_size,
        )
