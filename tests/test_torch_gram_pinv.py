"""The lstsq solve's pseudo-inverse on the card (``ops/cuda/gram_pinv.py``):
the kernel's twin against ``torch.linalg.pinv`` and the JAX package's
``jnp.linalg.pinv(rcond=1e-6)`` in float64, and the routing rule.

The twin follows ``csrc/gram_pinv.cu`` line for line (two-sided cyclic
Jacobi, then ``V diag(w) V^T`` with torch's relative cutoff), so these
tests hold the kernel's arithmetic; ``chip_smoke.py`` holds the kernel to
the twin on the card. Tolerance: ``tests/test_torch_cluster_faults.py``'s
float64 value bound, 1e-9 of each matrix's largest entry, on Grams whose
kept singular values span up to 1e6.
"""
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu_torch import PhysicalModel
from gigalens_tpu_torch.config import SimulatorConfig
from gigalens_tpu_torch.ops.cuda import gram_pinv as gp
from gigalens_tpu_torch.ops.cuda import launch_counts
from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, Shear
from gigalens_tpu_torch.prob import Prior
from gigalens_tpu_torch.prob import distributions as d
from gigalens_tpu_torch.simulator import LensSimulator

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_cluster_faults import PINV_TOL, _gram  # noqa: E402

RTOL = 1e-6
VTOL = PINV_TOL["float64"][0]


def _jax_pinv(a):
    with jax.enable_x64(True):
        return np.asarray(jnp.linalg.pinv(jnp.asarray(a), rcond=RTOL))


def _near_cutoff(a, margin=1e-6):
    """Matrices with a singular value within ``margin`` (relative) of the
    cutoff, where routes may keep or drop it."""
    s = np.linalg.svd(a, compute_uv=False)
    r = s / np.where(s[..., :1] > 0, s[..., :1], 1.0)
    return (np.abs(r / RTOL - 1.0) < margin).any(axis=-1)


def _assert_matches(a, p):
    """``p`` against torch and JAX at VTOL of each matrix's largest entry."""
    keep = ~_near_cutoff(a)
    for name, want in (("torch", torch.linalg.pinv(torch.tensor(a), rtol=RTOL).numpy()),
                       ("jax", _jax_pinv(a))):
        err = np.abs(p - want).max(axis=(-2, -1))
        scale = np.abs(want).max(axis=(-2, -1))
        worst = (err / np.where(scale > 0, scale, 1.0))[keep]
        assert worst.max() <= VTOL, f"twin vs {name}: {worst.max():.3e} of a matrix's max"


def _family_l_grams(bs=500):
    """(bs, 16, 16) Grams of family L's components (EPL + Shear, a Sersic
    lens light and Shapelets(4), all amplitudes linear) at prior draws, on
    a 40 px camera (0.13", no PSF), with one row's component vanished and
    one row's duplicated."""
    phys = PhysicalModel([EPL(23), Shear()], [SersicEllipse(use_lstsq=True)],
                         [Shapelets(4, use_lstsq=True)])
    prior = Prior(dict(
        lens_mass=[dict(theta_E=d.LogNormal(np.log(1.25), 0.25),
                        gamma=d.TruncatedNormal(2, 0.25, 1, 3), e1=d.Normal(0, 0.1),
                        e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05),
                        center_y=d.Normal(0, 0.05)),
                   dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05))],
        lens_light=[dict(R_sersic=d.LogNormal(np.log(1.0), 0.15), n_sersic=d.Uniform(2, 6),
                         e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05))],
        source_light=[dict(beta=d.LogNormal(np.log(0.2), 0.2), center_x=d.Normal(0, 0.25),
                           center_y=d.Normal(0, 0.25))]))
    sim = LensSimulator(phys, SimulatorConfig(delta_pix=0.13, num_pix=40, supersample=1),
                        bs=bs, device="cpu")
    params = prior.sample(torch.Generator().manual_seed(3), bs)
    ones = np.ones((40, 40), np.float32)
    with torch.no_grad():
        X = sim.lstsq_simulate(params, ones, ones, return_stacked=True)  # (bs, 40, 40, 16)
    X = X.reshape(bs, -1, X.shape[-1]).double() / 0.2
    X[1, :, 7] = 0.0
    X[2, :, 12] = X[2, :, 11]
    return (X.mT @ X).numpy()


@pytest.mark.quick
@pytest.mark.parametrize("case", ["vanished", "duplicated", "near_cutoff"])
def test_twin_matches_torch_and_jax_on_the_fault_grams(case):
    a = _gram(case, np.float64)
    p = gp.gram_pinv_reference(torch.tensor(a), RTOL)
    assert p.dtype == torch.float64 and torch.equal(p, p.mT)
    _assert_matches(a, p.numpy())


def test_twin_matches_torch_and_jax_on_family_l_grams():
    a = _family_l_grams()
    assert a.shape == (500, 16, 16) and np.linalg.cond(a).max() > 1e6
    p = gp.gram_pinv_reference(torch.tensor(a), RTOL).numpy()
    _assert_matches(a, p)
    # a matrix's bits do not depend on the batch it is in
    alone = gp.gram_pinv_reference(torch.tensor(a[:8]), RTOL).numpy()
    assert np.array_equal(alone, p[:8])


@pytest.mark.parametrize("n", [1, 32])
def test_twin_matches_torch_and_jax_at_depths_1_and_32(n):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((6, 3 * n, n)) * np.geomspace(1.0, 1e-3, n)
    X[1, :, -1] = 0.0  # a vanished component (depth 1: the zero matrix)
    a = X.transpose(0, 2, 1) @ X
    p = gp.gram_pinv_reference(torch.tensor(a), RTOL).numpy()
    assert p.shape == a.shape and np.isfinite(p).all()
    _assert_matches(a, p)


def test_a_nan_matrix_comes_out_nan_and_the_others_unchanged():
    a = np.stack([_gram(c, np.float64) for c in ("vanished", "duplicated", "near_cutoff")])
    bad = a.copy()
    bad[1, 3, 5] = np.nan
    bad[2, 0, 0] = np.inf
    clean = gp.gram_pinv_reference(torch.tensor(a), RTOL)
    p = gp.gram_pinv_reference(torch.tensor(bad), RTOL)
    assert torch.isnan(p[1:]).all()
    assert torch.equal(p[0], clean[0])


def test_route_by_device_dtype_and_depth(monkeypatch):
    def fake(device, dtype, n):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     shape=(500, n, n))

    f64, f32 = torch.float64, torch.float32
    assert gp.route(fake("cuda", f64, 16)) == "kernel"
    assert gp.route(fake("cuda", f64, 1)) == "kernel"
    assert gp.route(fake("cuda", f64, 32)) == "kernel"
    assert gp.route(fake("cuda", f64, 33)) == "fallback"
    assert gp.route(fake("cuda", f32, 16)) == "fallback"
    assert gp.route(types.SimpleNamespace(device=torch.device("cuda"), dtype=f64,
                                          shape=(4, 16, 15))) == "fallback"
    assert gp.route(fake("cpu", f64, 16)) == "cpu"
    assert gp.route(torch.zeros(2, 16, 16, dtype=f64)) == "cpu"

    calls = []
    monkeypatch.setattr(torch.linalg, "pinv", lambda a, rtol: calls.append(a) or "torch")
    monkeypatch.setitem(gp.launches, "gram_pinv_fallback", 0)
    # a CUDA float32 Gram takes torch's pinv and counts a fallback; a CPU one
    # takes it and counts nothing
    assert gp.gram_pinv(fake("cuda", f32, 16), RTOL) == "torch"
    assert gp.gram_pinv(torch.eye(3, dtype=f64), RTOL) == "torch"
    assert len(calls) == 2
    counts = launch_counts()
    assert counts["gram_pinv_fallback"] == 1 and "gram_pinv" in counts
