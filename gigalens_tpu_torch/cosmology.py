"""Background cosmology for multi-plane lensing (a copy of
:mod:`gigalens_tpu.cosmology`, which is numpy only).

A minimal flat-universe distance calculator. Multi-plane ray tracing
(:class:`gigalens_tpu_torch.model.PhysicalModel`) needs comoving-distance
ratios between deflector planes, and the time-delay likelihood the
time-delay distance; both are host-side float64 numbers evaluated once at
model construction, baked into the programs as scalar constants.
"""
from __future__ import annotations

import numpy as np

C_KM_S = 299792.458  # speed of light [km/s]


class FlatLambdaCDM:
    """Flat Lambda-CDM background: ``E(z) = sqrt(Om0 (1+z)^3 + (1 - Om0))``.

    Radiation and neutrinos are neglected (sub-0.1% for z < 10, far below
    lens-modeling needs). Distances are in Mpc; only *ratios* enter the
    multi-plane recursion, so ``H0`` cancels there.
    """

    def __init__(self, H0: float = 70.0, Om0: float = 0.3):
        self.H0 = float(H0)
        self.Om0 = float(Om0)
        self.hubble_distance = C_KM_S / self.H0

    def efunc(self, z):
        z = np.asarray(z, np.float64)
        return np.sqrt(self.Om0 * (1.0 + z) ** 3 + (1.0 - self.Om0))

    def comoving_distance(self, z: float) -> float:
        """Line-of-sight (= transverse, flat) comoving distance [Mpc]."""
        z = float(z)
        if z < 0:
            raise ValueError(f"z must be >= 0, got {z}")
        if z == 0.0:
            return 0.0
        # composite Simpson on a fixed fine grid: |error| ~ (dz)^4; at 4096
        # intervals this is << 1e-6 relative for any z < 20
        n = 4096
        zz = np.linspace(0.0, z, n + 1)
        f = 1.0 / self.efunc(zz)
        h = z / n
        s = f[0] + f[-1] + 4.0 * f[1:-1:2].sum() + 2.0 * f[2:-1:2].sum()
        return float(self.hubble_distance * s * h / 3.0)

    def angular_diameter_distance(self, z1: float, z2: float = None) -> float:
        """``D_A(z1, z2)`` [Mpc]; one argument means ``D_A(0, z)``. Flat
        universe: ``(D_C(z2) - D_C(z1)) / (1 + z2)``."""
        if z2 is None:
            z1, z2 = 0.0, z1
        if z2 < z1:
            raise ValueError(f"need z2 >= z1, got {z1} > {z2}")
        return (self.comoving_distance(z2) - self.comoving_distance(z1)) / (
            1.0 + z2
        )


def multiplane_factors(lens_redshifts, z_source, cosmology=None) -> np.ndarray:
    """Recursion coefficients for multi-plane ray tracing.

    Profiles keep their natural single-plane parameterization — ``deriv``
    returns the deflection *reduced to the source plane* (``theta_E`` defined
    with ``Sigma_cr(z_k, z_s)``, exactly as in single-plane use). The physical
    bend is then ``alpha_hat_k = T_s / (T_s - T_k) * alpha_k`` (flat universe,
    comoving distances T), and the angular position on plane j is

        theta_j = theta - sum_{k<j} f[k, j] * alpha_k(theta_k),
        f[k, j] = (T_j - T_k) T_s / (T_j (T_s - T_k)),

    with the source plane ray equation ``beta = theta - sum_k alpha_k(theta_k)``
    (all ``f[k, s] = 1`` by construction). Deflectors at equal redshift get
    ``f = 0`` between them — they simply co-add, reproducing the single-plane
    sum, so ties need no special casing.

    Returns an (N, N) float64 array, strictly lower-triangular in the sense
    ``f[k, j]`` used for k < j.
    """
    cosmo = cosmology if cosmology is not None else FlatLambdaCDM()
    zs = [float(z) for z in lens_redshifts]
    if any(b < a for a, b in zip(zs, zs[1:])):
        raise ValueError(
            f"lens_redshifts must be ascending (got {zs}); order the "
            "profile list by redshift"
        )
    if any(z >= z_source for z in zs):
        raise ValueError(
            f"every lens must be in front of the source: {zs} vs "
            f"z_source={z_source}"
        )
    if any(z <= 0 for z in zs):
        raise ValueError(f"lens redshifts must be positive, got {zs}")
    T = np.array([cosmo.comoving_distance(z) for z in zs], np.float64)
    Ts = cosmo.comoving_distance(float(z_source))
    n = len(zs)
    F = np.zeros((n, n), np.float64)
    for j in range(n):
        for k in range(j):
            F[k, j] = (T[j] - T[k]) * Ts / (T[j] * (Ts - T[k]))
    return F
