"""Profile base classes (PyTorch port of :mod:`gigalens_tpu.profiles.base`).

Mass profiles expose ``deriv(x, y, **params) -> (alpha_x, alpha_y)``; light
profiles expose ``light(x, y, **params)``. Coordinates and per-sample
parameters only need to be mutually broadcastable: the simulator calls
profiles with coordinates shaped ``(npix,)`` and parameters shaped
``(bs, 1)``, giving batch-leading ``(bs, npix)`` outputs. The Hessian helpers
are not ported yet.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import torch


class Parameterized(ABC):
    """A named profile with an ordered list of learnable parameter names."""

    _name: str
    _params: List[str]

    def __init__(self, *args, **kwargs):
        self.name = self._name
        self.params = list(self._params)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class MassProfile(Parameterized, ABC):
    """Interface for a mass (deflector) profile."""

    @abstractmethod
    def deriv(self, x, y, **params):
        """Deflection angle (alpha_x, alpha_y) at image-plane coords (x, y)."""


class LightProfile(Parameterized, ABC):
    """Interface for a light (surface-brightness) profile.

    ``use_lstsq`` marks the amplitude as a linear parameter solved by least
    squares instead of being sampled; the simulator does not take such
    profiles yet (ROADMAP M13).
    """

    _amp = "Ie"

    def __init__(self, use_lstsq: bool = False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._use_lstsq = bool(use_lstsq)
        if self._amp and not self._use_lstsq and self._amp not in self.params:
            self.params.append(self._amp)

    @property
    def use_lstsq(self) -> bool:
        return self._use_lstsq

    @abstractmethod
    def light(self, x, y, **params):
        """Surface brightness at (x, y), broadcast over (batch..., pixels)."""


def rotate(x, y, phi):
    """Rotates coordinates by angle -phi (the lensing-standard frame change)."""
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    return x * cos_phi + y * sin_phi, -x * sin_phi + y * cos_phi


def ellipticity_to_polar(e1, e2, e_max=0.9999):
    """(e1, e2) -> (modulus e, axis ratio q, position angle phi).

    Hardened at exactly e1 = e2 = 0 like the JAX package: the epsilon goes
    inside the sqrt, and the angle's arguments are swapped for the constant
    (0, 1) in the degenerate region so phi = 0 with zero gradient.
    """
    degenerate = (e1 * e1 + e2 * e2) < 1e-24
    phi = torch.atan2(
        torch.where(degenerate, torch.zeros_like(e2), e2),
        torch.where(degenerate, torch.ones_like(e1), e1),
    ) / 2
    e = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=e_max)
    q = (1 - e) / (1 + e)
    return e, q, phi
