"""Kernel math in torch ops, mirrored line for line by ``csrc/lens_math.cuh``.

Port of :mod:`gigalens_tpu.ops.pallas._math`'s ``half_angle`` and ``powp``
for the kernels' plain twins. (The JAX module's polynomial ``atan2`` exists
only because Mosaic cannot lower ``atan2``; nothing on this path needs it.)
"""
from __future__ import annotations

import torch


def powp(base, expo):
    """base ** expo for strictly positive base, as exp(expo * log(base))."""
    return torch.exp(expo * torch.log(base))


def half_angle(e1, e2):
    """(cos phi, sin phi) for phi = atan2(e2, e1) / 2 — pure algebra.

    The half-angle construction (not atan2 + cos/sin) keeps the rotation's
    derivatives free of branch-point roughness, which HMC leapfrog energies
    are sensitive to. cos phi = sqrt((1 + cos 2phi)/2), sin phi = sin 2phi /
    (2 cos phi), branching on the sign of e1 so the division is always by
    the well-conditioned component; smooth except the genuine branch cut at
    e2 = 0, e1 < 0.
    """
    # epsilon INSIDE the sqrt: finite value and gradient at the origin
    m = torch.sqrt(e1 * e1 + e2 * e2 + 1e-24)
    # below the floor the direction is undefined: the identity rotation
    degenerate = m <= 1e-11
    c2 = torch.where(degenerate, torch.ones_like(m), e1 / m)
    s2 = torch.where(degenerate, torch.zeros_like(m), e2 / m)
    pos = e1 >= 0
    cp_pos = torch.sqrt(torch.clamp((1.0 + c2) * 0.5, min=1e-12))
    sgn = torch.where(e2 >= 0, torch.ones_like(e2), -torch.ones_like(e2))
    sp_neg = sgn * torch.sqrt(torch.clamp((1.0 - c2) * 0.5, min=1e-12))
    cp = torch.where(pos, cp_pos, 0.5 * s2 / sp_neg)
    sp = torch.where(pos, 0.5 * s2 / cp_pos, sp_neg)
    return cp, sp


def half_angle_bwd(e1, e2, g_cp, g_sp):
    """Hand-derived VJP of :func:`half_angle`: (g_cp, g_sp) -> (g_e1, g_e2)."""
    m = torch.sqrt(e1 * e1 + e2 * e2 + 1e-24)
    degenerate = m <= 1e-11
    c2 = torch.where(degenerate, torch.ones_like(m), e1 / m)
    s2 = torch.where(degenerate, torch.zeros_like(m), e2 / m)
    pos = e1 >= 0
    a = (1.0 + c2) * 0.5
    cp_pos = torch.sqrt(torch.clamp(a, min=1e-12))
    sgn = torch.where(e2 >= 0, torch.ones_like(e2), -torch.ones_like(e2))
    b = (1.0 - c2) * 0.5
    sq_b = torch.sqrt(torch.clamp(b, min=1e-12))
    sp_neg = sgn * sq_b
    zero = torch.zeros_like(g_cp)
    # e1 >= 0: cp = cp_pos, sp = 0.5 s2 / cp_pos
    g_cp_pos = torch.where(pos, g_cp - g_sp * 0.5 * s2 / (cp_pos * cp_pos), zero)
    # e1 < 0: cp = 0.5 s2 / sp_neg, sp = sp_neg
    g_sp_neg = torch.where(pos, zero, g_sp - g_cp * 0.5 * s2 / (sp_neg * sp_neg))
    g_s2 = torch.where(pos, g_sp * 0.5 / cp_pos, g_cp * 0.5 / sp_neg)
    g_c2 = torch.where(a > 1e-12, g_cp_pos * 0.25 / cp_pos, zero)
    g_c2 = g_c2 - torch.where(b > 1e-12, g_sp_neg * sgn * 0.25 / sq_b, zero)
    # (c2, s2) = (e1, e2) / m away from the degenerate floor
    g_c2 = torch.where(degenerate, zero, g_c2)
    g_s2 = torch.where(degenerate, zero, g_s2)
    g_m = -(g_c2 * e1 + g_s2 * e2) / (m * m)
    g_e1 = g_c2 / m + g_m * e1 / m
    g_e2 = g_s2 / m + g_m * e2 / m
    return g_e1, g_e2
