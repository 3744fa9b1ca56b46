"""The cluster machinery (dPIS / dPIE / dPIEP, ScalingRelation, the Taylor
series profiles, DPIESubhalo(Series)), the builder's series stage on a real
profile, and the cluster scene of config #5 at a small size, against the
JAX package on the same numpy inputs.

Tolerances (float32 on both sides):
* profile fields: rtol 1e-5 plus 1e-5 of the field's max |value| (dPIE's
  complex formula: 1e-4, its log and atan2 round differently in the two
  libraries); parameter gradients: 1e-4 of the per-column max;
* series coefficients (nested forward mode against Taylor mode): float64
  on both sides to 1e-7 of each order's max; in float32, both against
  JAX's float64 coefficients, the port within 4x JAX's own error
  (test_series_coefficients_match_jax says why not 1e-4 of the max);
* the scene (image, log_prob with pixels and positions, z-gradients):
  rtol 1e-4, gradients 1e-4 of each sample's largest component, as
  tests/test_torch_pointsource.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.ops.pallas import fused_builder as jfb
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.base import MassProfile as JMassProfile
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass import dpie as jdpie
from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhalo as JDPIESubhalo
from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhaloSeries as JDPIESubhaloSeries
from gigalens_tpu.profiles.mass.nfw import NFW_ELLIPSE as JNFW_ELLIPSE
from gigalens_tpu.profiles.mass.scaling import ScalingRelation as JScalingRelation
from gigalens_tpu.profiles.mass.series import MassSeries as JMassSeries
from gigalens_tpu.profiles.mass.series import taylor_derivs as jtaylor_derivs
from gigalens_tpu.profiles.mass.sie import NIE as JNIE
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import ModellingSequence
from gigalens_tpu_torch.inference.sequence import map_optimizer
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.ops.cuda import fused_builder as fb
from gigalens_tpu_torch.profiles.mass import (
    DPIE, DPIEP, DPIS, NIE, DPIESubhalo, DPIESubhaloSeries, MassSeries, ScalingRelation,
    ScalingRelationSeries,
)
from gigalens_tpu_torch.profiles.mass import scaling
from gigalens_tpu_torch.profiles.mass.series import taylor_derivs
from gigalens_tpu_torch.simulator import LensSimulator

G, CHUNK = 7, 3


def _catalogue(seed=0, g=G, spread=1.5):
    rng = np.random.default_rng(seed)
    return dict(
        lum=rng.uniform(0.3, 3.0, g).astype(np.float32),
        center_x=rng.normal(0, spread, g).astype(np.float32),
        center_y=rng.normal(0, spread, g).astype(np.float32),
        e1=rng.uniform(-0.2, 0.2, g).astype(np.float32),
        e2=rng.uniform(-0.2, 0.2, g).astype(np.float32),
    )


def _coords(n=600, seed=1, half=3.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-half, half, n).astype(np.float32),
            rng.uniform(-half, half, n).astype(np.float32))


def _close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _t(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}


# ------------------------------------------------------------------ profiles

DPIE_P = dict(theta_E=(0.3, 1.2), r_core=(0.05, 0.3), r_cut=(0.8, 3.0), e1=(-0.3, 0.3),
              e2=(-0.3, 0.3), center_x=(-0.3, 0.3), center_y=(-0.3, 0.3))
PROFILES = {
    "DPIS": (jdpie.DPIS, DPIS, {k: DPIE_P[k] for k in
                                ("theta_E", "r_core", "r_cut", "center_x", "center_y")}, 1e-5),
    "DPIE": (jdpie.DPIE, DPIE, DPIE_P, 1e-4),
    "DPIEP": (jdpie.DPIEP, DPIEP, dict(theta_E=(0.3, 1.2), Ra=(0.05, 0.3), Rs=(0.8, 3.0),
                                        e1=(-0.3, 0.3), e2=(-0.3, 0.3), center_x=(-0.3, 0.3),
                                        center_y=(-0.3, 0.3)), 1e-5),
}


def _draw(ranges, bs=3, seed=2):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, (bs, 1)).astype(np.float32) for k, (lo, hi) in ranges.items()}


def _branch_cut_case():
    """dPIE samples and points where the ellipse-frame y is exactly zero:
    e2 = 0 (phi = 0), points at y == center_y on both sides of the centre,
    and a point on the centre itself."""
    p = _draw(DPIE_P, bs=2, seed=9)
    p["e2"][:] = 0.0
    p["center_x"][:] = 0.25
    p["center_y"][:] = -0.5
    x, y = _coords(200, seed=3)
    x[:6] = (-2.0, -0.7, -0.1, 0.9, 2.5, 0.25)
    y[:6] = -0.5
    return p, x, y


@pytest.mark.quick
@pytest.mark.parametrize("name", list(PROFILES))
def test_dpie_family_fields_match_jax(name):
    jcls, tcls, ranges, rtol = PROFILES[name]
    x, y = _coords()
    p = _draw(ranges)
    jprof, tprof = jcls(), tcls()
    want = {"deriv": jprof.deriv(jnp.asarray(x), jnp.asarray(y), **_j(p)),
            "hessian": jprof.hessian(jnp.asarray(x), jnp.asarray(y), **_j(p)),
            "convergence": (jprof.convergence(jnp.asarray(x), jnp.asarray(y), **_j(p)),)}
    got = {"deriv": tprof.deriv(torch.tensor(x), torch.tensor(y), **_t(p)),
           "hessian": tprof.hessian(torch.tensor(x), torch.tensor(y), **_t(p)),
           "convergence": (tprof.convergence(torch.tensor(x), torch.tensor(y), **_t(p)),)}
    for field in want:
        for g, w in zip(got[field], want[field]):
            _close(g, w, rtol)


@pytest.mark.parametrize("name", ["DPIE", "NFW_ELLIPSE"])
def test_closed_form_hessians_equal_forward_mode(name):
    """The dPIE's Hessian (the Jacobian of its complex formula) and
    NFW_ELLIPSE's (NFW's closed form at the stretched coordinates) against
    the forward-mode default, torch.func.jvp of their own deriv, in
    float64. The dPIE's is the same function: 1e-12 of the max (measured
    1e-15). NFW's closed-form convergence and the derivative of its
    deflection's series differ inside the series windows (|X - 1| < 0.03,
    X < 0.05) by the series' truncation, as the JAX package's NFW Hessian
    does: 5e-5 of the max there (measured 1.0e-5). JAX takes both
    elliptical Hessians by forward mode."""
    from gigalens_tpu_torch.profiles.base import MassProfile
    from gigalens_tpu_torch.profiles.mass import NFW_ELLIPSE

    prof, ranges = {"DPIE": (DPIE(), DPIE_P), "NFW_ELLIPSE": (NFW_ELLIPSE(), dict(
        Rs=(5.0, 15.0), alpha_Rs=(1.0, 6.0), e1=(-0.2, 0.2), e2=(-0.2, 0.2),
        center_x=(-0.5, 0.5), center_y=(-0.5, 0.5)))}[name]
    x, y = (torch.tensor(c, dtype=torch.float64) for c in _coords(800, seed=14, half=6.0))
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in _draw(ranges, seed=15).items()}
    want = MassProfile.hessian(prof, x, y, **p)
    tol = 1e-12 if name == "DPIE" else 5e-5
    for g, w in zip(prof.hessian(x, y, **p), want):
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


def test_dpie_branch_cut_and_centre_match_jax():
    """Points on the rotated x-axis, where atan2's imaginary argument is a
    signed zero, land on the same side of the branch cut as in JAX."""
    p, x, y = _branch_cut_case()
    want = jdpie.DPIE().deriv(jnp.asarray(x), jnp.asarray(y), **_j(p))
    got = DPIE().deriv(torch.tensor(x), torch.tensor(y), **_t(p))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("name", list(PROFILES))
def test_dpie_family_parameter_gradients_match_jax(name):
    jcls, tcls, ranges, _ = PROFILES[name]
    x, y = _coords(300, seed=4)
    p = _draw(ranges, seed=5)
    keys = list(p)

    def j_obj(*vals):
        kw = dict(zip(keys, vals))
        fx, fy = jcls().deriv(jnp.asarray(x), jnp.asarray(y), **kw)
        h = jcls().hessian(jnp.asarray(x), jnp.asarray(y), **kw)
        return jnp.sum(fx + 2 * fy) + jnp.sum(h[0] - h[1])

    want = jax.grad(j_obj, argnums=tuple(range(len(keys))))(*(jnp.asarray(p[k]) for k in keys))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    fx, fy = tcls().deriv(torch.tensor(x), torch.tensor(y), **tp)
    h = tcls().hessian(torch.tensor(x), torch.tensor(y), **tp)
    got = torch.autograd.grad(torch.sum(fx + 2 * fy) + torch.sum(h[0] - h[1]),
                              [tp[k] for k in keys])
    for k, g, w in zip(keys, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{name}.{k}")


DEGENERATE = {
    "zero radii": dict(theta_E=0.0, r_core=0.0, r_cut=0.0, e1=0.1, e2=-0.05),
    "circular": dict(theta_E=0.3, r_core=0.08, r_cut=1.5, e1=0.0, e2=0.0),
    "tie": dict(theta_E=0.3, r_core=0.5, r_cut=0.5, e1=0.1, e2=0.05),
}


def _degenerate(label, dtype):
    """(port values, port gradients, JAX values, JAX gradients) of
    sum(fx * fy + fx) at three points, in ``dtype`` on both sides."""
    x = np.array([3.1, -2.8, 2.0], dtype)
    y = np.array([0.4, -0.6, 1.0], dtype)
    p = {k: dtype(v) for k, v in DEGENERATE[label].items()}
    keys = list(p)

    def j_obj(*vals):
        fx, fy = jdpie.DPIE().deriv(jnp.asarray(x), jnp.asarray(y), center_x=2.0, center_y=1.0,
                                    **dict(zip(keys, vals)))
        return jnp.sum(fx * fy + fx), (fx, fy)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    fx, fy = DPIE().deriv(torch.tensor(x), torch.tensor(y), center_x=2.0, center_y=1.0, **tp)
    got = torch.autograd.grad(torch.sum(fx * fy + fx), [tp[k] for k in keys])
    want, jvals = jax.grad(j_obj, argnums=tuple(range(len(keys))), has_aux=True)(
        *(jnp.asarray(p[k]) for k in keys))
    return (fx.detach(), fy.detach()), got, jvals, want


@pytest.mark.parametrize("label", list(DEGENERATE))
def test_dpie_degenerate_members_are_finite_and_match_jax(label):
    """r_core = r_cut = 0 gives exactly 0 (a zero-luminosity padded member),
    e1 = e2 = 0 the smooth e -> 0 limit through ``_E_MIN``, and every
    gradient is finite and JAX's (float32, rtol 1e-4). At r_core == r_cut
    both sides split the tie's gradient evenly: in float32 the 1/(hi - lo)
    of the floored pair amplifies rounding to a few percent on both sides
    against float64, so the split is held in float64, at 1e-8."""
    vals, got, jvals, want = _degenerate(label, np.float32)
    for g, w in zip(vals, jvals):
        _close(g, w, 1e-4)
    for g in got:
        assert torch.isfinite(g).all()
    if label == "zero radii":
        assert all(torch.equal(v, torch.zeros_like(v)) for v in vals)
        h = DPIE().hessian(torch.tensor([3.1, -2.8]), torch.tensor([0.4, -0.6]), center_x=2.0,
                           center_y=1.0, **_t({k: np.float32(v) for k, v in
                                               DEGENERATE[label].items()}))
        assert all(torch.isfinite(v).all() for v in h)
    if label == "tie":
        with jax.enable_x64(True):
            _, got, _, want = _degenerate(label, np.float64)
        assert float(got[1]) == pytest.approx(float(got[2]), rel=1e-12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8 if label == "tie" else 1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------- scaling relation

def _relations(chunk=CHUNK, cat=None):
    cat = _catalogue() if cat is None else cat
    kw = dict(lum_star=1.0, galaxy_catalogue=cat, chunk_size=chunk)
    return JDPIESubhalo(**kw), DPIESubhalo(**kw)


SCALES = dict(theta_E=np.array([[0.9], [0.5]], np.float32),
              r_core=np.array([[0.08], [0.12]], np.float32),
              r_cut=np.array([[1.5], [2.2]], np.float32))


@pytest.mark.parametrize("one_pass", [False, True])
@pytest.mark.parametrize("remat", [True, False])
def test_scaling_relation_matches_jax_with_and_without_checkpoint(remat, one_pass, monkeypatch):
    """deriv and hessian of a padded DPIESubhalo (7 members, chunks of 3),
    and the scale gradients of both against jax.grad; with ``remat`` the
    chunks of deriv run under torch.utils.checkpoint (counted), without it
    plainly, with the same gradients; chunk by chunk, or (``one_pass``, as
    for few coordinates) every member at once."""
    monkeypatch.setattr(scaling, "ONE_PASS_ELEMENTS", 1 << 40 if one_pass else 0)
    calls = []

    def counting(fn, *args, **kw):
        calls.append(1)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(scaling, "checkpoint", counting)
    jrel, rel = _relations()
    x, y = _coords(400, seed=6)
    keys = list(SCALES)

    def j_obj(*vals):
        kw = dict(zip(keys, vals))
        fx, fy = jrel.deriv(jnp.asarray(x), jnp.asarray(y), **kw)
        h = jrel.hessian(jnp.asarray(x), jnp.asarray(y), **kw)
        return jnp.sum(fx - 0.5 * fy) + jnp.sum(h[0] * h[3])

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in SCALES.items()}
    if remat:
        fx, fy = rel.deriv(torch.tensor(x), torch.tensor(y), **tp)
    else:
        fx, fy = rel._chunked_sum(rel.profile.deriv, torch.tensor(x), torch.tensor(y), tp)
    h = rel.hessian(torch.tensor(x), torch.tensor(y), **tp)
    assert len(calls) == ((1 if one_pass else rel.n_chunks) if remat else 0)
    wx, wy = jrel.deriv(jnp.asarray(x), jnp.asarray(y), **_j(SCALES))
    wh = jrel.hessian(jnp.asarray(x), jnp.asarray(y), **_j(SCALES))
    for g, w in zip((fx, fy, *h), (wx, wy, *wh)):
        _close(g, w, 1e-4)
    got = torch.autograd.grad(torch.sum(fx - 0.5 * fy) + torch.sum(h[0] * h[3]),
                              [tp[k] for k in keys])
    want = jax.grad(j_obj, argnums=(0, 1, 2))(*(jnp.asarray(SCALES[k]) for k in keys))
    for k, g, w in zip(keys, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_scaling_relation_chunking_invariance_and_padding(monkeypatch):
    """Chunks of 7 (none padded), 3 and 2 give one sum; the zero-luminosity
    padding contributes exactly 0 (a catalogue padded with members of zero
    luminosity sums to the same bits as the unpadded one)."""
    monkeypatch.setattr(scaling, "ONE_PASS_ELEMENTS", 0)
    x, y = _coords(300, seed=7)
    outs = []
    for chunk in (None, 3, 2):
        _, rel = _relations(chunk)
        outs.append(rel.deriv(torch.tensor(x), torch.tensor(y), **_t(SCALES))[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[2], outs[0], rtol=1e-5, atol=1e-5)
    cat = _catalogue()
    padded = {k: np.concatenate([v, np.zeros(2, np.float32) if k == "lum" else v[-2:]])
              for k, v in cat.items()}
    _, rel9 = _relations(3, padded)
    _, rel7 = _relations(3, cat)
    got9 = rel9.deriv(torch.tensor(x), torch.tensor(y), **_t(SCALES))
    got7 = rel7.deriv(torch.tensor(x), torch.tensor(y), **_t(SCALES))
    assert rel7.n_chunks == 3 and all(torch.equal(a, b) for a, b in zip(got7, got9))


def test_scaling_relation_of_nie_matches_jax():
    """The sie arm's member stack: ScalingRelation(NIE) with a per-member
    core from the catalogue, carried across by interop."""
    cat = dict(_catalogue(), s_scale=np.full(G, 0.05, np.float32))
    jrel = JScalingRelation(JNIE(), ["theta_E"], 1.0, {"theta_E": 0.5}, cat, chunk_size=CHUNK)
    rel = phys_model_from_reference(JPhysicalModel([jrel], [], [])).lenses[0]
    assert type(rel) is ScalingRelation and type(rel.profile) is NIE
    assert rel.chunk_size == CHUNK and rel.not_scaling_params == jrel.not_scaling_params
    x, y = _coords(300, seed=8)
    te = np.array([[0.3], [0.45]], np.float32)
    for g, w in zip(rel.deriv(torch.tensor(x), torch.tensor(y), theta_E=torch.tensor(te)),
                    jrel.deriv(jnp.asarray(x), jnp.asarray(y), theta_E=jnp.asarray(te))):
        _close(g, w, 1e-5)


# ----------------------------------------------------------------- the series

def test_taylor_derivs_polynomial():
    d = taylor_derivs(lambda r: torch.stack([r**3, torch.sin(r)]), torch.tensor(2.0), 3)
    want = [[8.0, math.sin(2)], [12.0, math.cos(2)], [12.0, -math.sin(2)], [6.0, -math.cos(2)]]
    np.testing.assert_allclose(torch.stack(d).numpy(), want, rtol=1e-4, atol=1e-5)


def test_taylor_derivs_match_jet_on_dpie():
    """Nested forward mode against JAX's Taylor mode on the dPIE deflection
    to order 4, in float64 on both sides (the same arithmetic: measured
    <= 1e-12 of each order's max)."""
    x, y = (c.astype(np.float64) for c in _coords(200, seed=10))
    kw = {k: np.float64(v) for k, v in dict(theta_E=1.0, r_core=0.1, e1=0.1, e2=-0.05,
                                             center_x=0.2, center_y=-0.1).items()}

    def tf(r):
        return torch.stack(DPIE().deriv(torch.tensor(x), torch.tensor(y), r_cut=r, **kw))

    with jax.enable_x64(True):
        want = jtaylor_derivs(lambda r: jnp.stack(jdpie.DPIE().deriv(
            jnp.asarray(x), jnp.asarray(y), r_cut=r, **kw)), jnp.float64(1.7), 4)
    got = taylor_derivs(tf, torch.tensor(1.7, dtype=torch.float64), 4)
    for n, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9 * np.abs(np.asarray(w)).max(), err_msg=f"order {n}")


def _series_pair(kind, order):
    """(JAX series, port series, constants) with JAX's coefficients set."""
    if kind == "mass":
        consts = dict(r_cut=1.6, r_core=0.12, center_x=0.1, center_y=-0.05, e1=0.1, e2=-0.08)
        js, ts = (cls(prof(), "r_cut", "theta_E", order=order)
                  for cls, prof in ((JMassSeries, jdpie.DPIE), (MassSeries, DPIE)))
    else:
        consts = dict(r_cut=1.5, r_core=0.08)
        cat = _catalogue()
        js = JDPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=order,
                                chunk_size=CHUNK)
        ts = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=order,
                               chunk_size=CHUNK)
    return js, ts, consts


@pytest.mark.parametrize("kind, order, method", [
    ("mass", 3, "deriv"), ("mass", 3, "hessian"), ("mass", 5, "deriv"),
    ("scaling", 3, "deriv"), ("scaling", 3, "hessian"), ("scaling", 5, "deriv")])
def test_series_coefficients_match_jax(kind, order, method):
    """precompute_deriv / precompute_hessian in float32, as both packages
    run them, each order n against the float64 coefficients: the port's
    error within 4x JAX's own float32 error plus 1e-6 of max |coef_n|
    (measured: at most 2.7x). Both errors grow with the order, to ~1e-3 of
    the max at order 3 and 0.1-4 at order 5, at points where the dPIE's
    complex formula cancels singular terms, so 1e-4 of the max between the
    two float32 results cannot hold past order 1. For one profile the
    float64 coefficients equal JAX's to 1e-7 of the max (measured <=
    1.2e-8): nested forward mode is Taylor mode. (The order-5 Hessians are
    left out for their cost on the CPU: 30-50 s each, most of it JAX's
    compile of the Taylor-mode program.)"""
    js, ts, consts = _series_pair(kind, order)
    x, y = _coords(300, seed=11)
    name = f"precompute_{method}"
    j32 = np.asarray(getattr(js, name)(order, jnp.asarray(x), jnp.asarray(y), **consts))
    p32 = getattr(ts, name)(order, torch.tensor(x), torch.tensor(y), **consts).numpy()
    p64 = getattr(ts, name)(order, torch.tensor(x).double(), torch.tensor(y).double(),
                            **consts).numpy()
    assert p32.shape == j32.shape == (order + 1, 2 if method == "deriv" else 3, 300)
    if kind == "mass" and (order, method) in ((5, "deriv"), (3, "hessian")):
        with jax.enable_x64(True):
            j64 = np.asarray(getattr(_series_pair(kind, order)[0], name)(
                order, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                **{k: np.float64(v) for k, v in consts.items()}))
        for n in range(order + 1):
            assert np.abs(p64[n] - j64[n]).max() <= 1e-7 * np.abs(j64[n]).max(), n
    for n in range(order + 1):
        err_j, err_p = (np.abs(c[n] - p64[n]).max() for c in (j32, p32))
        assert err_p <= 4 * err_j + 1e-6 * np.abs(p64[n]).max(), (n, err_p, err_j)


def test_series_on_and_off_grid_match_jax_and_the_direct_stack():
    """On the grid the series (one matmul) against JAX's series and the
    direct member sum (JAX's own tolerance, tests/test_cluster.py); off the
    grid (a different shape) the exact fallback equals the direct stack."""
    js, ts, consts = _series_pair("scaling", 3)
    x, y = _coords(250, seed=12)
    for s, xx, yy in ((js, jnp.asarray(x), jnp.asarray(y)), (ts, torch.tensor(x), torch.tensor(y))):
        s.set_constants(consts)
        s.set_grid(xx, yy)
        s.set_deriv()
        s.set_hessian()
    _, direct = _relations()
    x, y = torch.tensor(x), torch.tensor(y)  # one tensor each: compared with the grid once
    for r_cut in (1.5, 1.62, 1.35):
        te, rc = np.array([0.8, 0.6], np.float32), np.array([r_cut, r_cut + 0.05], np.float32)
        got = ts.deriv(x, y, theta_E=torch.tensor(te), r_cut=torch.tensor(rc))
        want = js.deriv(js._x, js._y, theta_E=jnp.asarray(te), r_cut=jnp.asarray(rc))
        exact = direct.deriv(x, y, theta_E=torch.tensor(te[:, None]),
                             r_core=torch.tensor(0.08), r_cut=torch.tensor(rc[:, None]))
        for g, w, e in zip(got, want, exact):
            _close(g, w, 1e-4)
            np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=5e-3, atol=2e-3)
    gh = ts.hessian(x, y, theta_E=torch.tensor([0.8]), r_cut=torch.tensor([1.55]))
    wh = js.hessian(js._x, js._y, theta_E=jnp.asarray([0.8]), r_cut=jnp.asarray([1.55]))
    for g, w in zip(gh, wh):
        _close(g, w, 1e-4)
    # off the grid: the direct ScalingRelation sum, exactly
    xo, yo = x[:5], y[:5]
    kw = dict(theta_E=torch.tensor([[0.8]]), r_cut=torch.tensor([[1.7]]))
    off = ts.deriv(xo, yo, **kw)
    ref = ts._rel.deriv(xo, yo, r_core=torch.tensor(0.08), **kw)
    assert all(torch.equal(a, b) for a, b in zip(off, ref))
    assert ts.grid_checks == 1  # x compared with the grid once, then remembered


def test_series_stale_grid_raises_and_checks_each_tensor_once():
    js, ts, consts = _series_pair("mass", 2)
    x, y = torch.linspace(-1, 1, 16), torch.linspace(-1, 1, 16)
    ts.set_constants(consts)
    ts.set_grid(x, y)
    ts.set_deriv()
    kw = dict(r_cut=torch.tensor([1.7]), theta_E=torch.tensor([1.0]))
    twin = x.clone()  # equal values, another tensor: one comparison, then cached
    for _ in range(3):
        assert torch.isfinite(ts.deriv(twin, y, **kw)[0]).all()
    assert ts.grid_checks == 1
    twin.add_(0.0)  # an in-place write bumps the version: compared again
    ts.deriv(twin, y, **kw)
    assert ts.grid_checks == 2
    with pytest.raises(ValueError, match="not its values"):
        ts.deriv(x + 0.5, y, **kw)
    assert ts.series_grid(x) is ts.series_grid(x.clone())  # the padded grid is built once
    assert ts.series_grid(x).shape == (8, 16)


# ------------------------------------------------------------ the builder spec

def _cluster_jphys(order=3, n_max=2, lstsq=False, g=G, spread=1.5, chunk=CHUNK):
    members = JDPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=_catalogue(g=g, spread=spread),
                                 order=order, chunk_size=chunk)
    return JPhysicalModel([JNFW_ELLIPSE(), members], [], [JShapelets(n_max, use_lstsq=lstsq)])


def test_build_spec_matches_jax_for_the_cluster_model():
    """The same stages, labels and pack columns as JAX's build_spec (the
    series column's dv transform included), the same padded coefficient
    grid from the provider, None before set_deriv; None where a series
    parameter is a constant."""
    jphys = _cluster_jphys()
    phys = phys_model_from_reference(jphys)
    jm, tm = jphys.lenses[1], phys.lenses[1]
    x, y = _coords(512, seed=13)
    spec = fb.build_spec(phys)
    jspec = jfb.build_spec(jphys)
    assert spec.label == jspec.label == "NFW_ELLIPSE+DPIESubhaloSeries+Shapelets"
    assert [c[:3] if isinstance(c, tuple) else c for c in spec.pack_cols] == [
        c[:3] if isinstance(c, tuple) else c for c in jspec.pack_cols]
    assert [st.op for st in spec.stages] == [fb.NFW_E, fb.SERIES, fb.SHAPELETS]
    assert spec.stages[1].order == 3 and spec.stages[1].extra == 0
    assert spec.gather_extras(torch.tensor(x), torch.tensor(y)) is None  # not set yet
    consts = dict(r_cut=1.5, r_core=0.08)
    for m, xx, yy in ((jm, jnp.asarray(x), jnp.asarray(y)), (tm, torch.tensor(x), torch.tensor(y))):
        m.set_constants(consts)
        m.set_grid(xx, yy)
        m.set_deriv()
    (grid,) = spec.gather_extras(tm._x, tm._y)
    jm._deriv_coefs = jnp.asarray(tm._deriv_coefs.numpy())  # JAX's layout of the same numbers
    (jgrid,) = jspec.gather_extras(jm._x, jm._y)
    assert grid.shape == jgrid.shape == (8, 512)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    v = torch.tensor([1.4, 1.7])
    torch.testing.assert_close(spec.pack_cols[6][3](v), v - 1.5)
    # a constant series parameter: no stage on either side
    cphys = JPhysicalModel(jphys.lenses, [], jphys.source_light,
                           lenses_constants=[{}, dict(r_cut=1.5)])
    assert jfb.build_spec(cphys) is None
    assert fb.build_spec(phys_model_from_reference(cphys)) is None


# --------------------------------------------------------------- the scene

@pytest.fixture(scope="module")
def scene():
    """The config #5 dpie arm at a small size: NFW_ELLIPSE + 7 series
    members (chunks of 3) + Shapelets(2), 32 px at 0.25", a 5x5 PSF, pixels
    and four image positions; JAX's series precomputed on its probe grid."""
    jphys = _cluster_jphys(spread=2.5)
    shp = jphys.source_light[0]
    tree = dict(lens_mass=[
        dict(Rs=jd.LogNormal(np.log(6.0), 0.2), alpha_Rs=jd.LogNormal(np.log(2.0), 0.3),
             e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.3),
             center_y=jd.Normal(0, 0.3)),
        dict(theta_E=jd.LogNormal(np.log(0.3), 0.3), r_cut=jd.LogNormal(np.log(1.5), 0.2))],
        source_light=[dict(beta=jd.LogNormal(np.log(0.4), 0.2), center_x=jd.Normal(0, 0.2),
                           center_y=jd.Normal(0, 0.2),
                           **{a: jd.Normal(0, 5.0) for a in shp._amp_names})])
    jprior = JPrior(tree)
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    jcfg = JSimulatorConfig(delta_pix=0.25, num_pix=32, supersample=1,
                            kernel=(g / g.sum()).astype(np.float32), use_fused_render=False)
    members = jphys.lenses[1]
    members.set_constants(dict(r_cut=1.5, r_core=0.08))
    probe = JLensSimulator(jphys, jcfg, bs=1)
    members.set_grid(probe.img_x, probe.img_y)
    members.set_deriv()
    return jphys, jprior, jcfg


IX = np.array([1.8, -1.6, 0.4, -0.5], np.float32)
IY = np.array([0.6, -0.4, 1.9, -1.7], np.float32)


def _probs(jprior, obs, positions=True):
    kw = dict(background_rms=0.1, exp_time=500.0)
    if positions:
        err = np.full(4, 0.1, np.float32)
        kw.update(centroids_x=[IX], centroids_y=[IY], centroids_errors_x=[err],
                  centroids_errors_y=[err])
    return (JForwardProbModel(jprior, obs, **kw),
            ForwardProbModel(prior_from_reference(jprior), obs, device="cpu", **kw))


@pytest.mark.parametrize("fused", [True, False])
def test_cluster_scene_image_log_prob_and_gradient_match_jax(fused, scene):
    """The port's image (through the builder's plain twins with the series
    stage, or unfused) and log_prob with pixels and positions (the members'
    off-grid Hessian at the centroids in forward mode), with its
    z-gradient, against JAX's unfused LensSimulator and ForwardProbModel.
    The port takes JAX's coefficients through interop and binds them to
    its own grid."""
    jphys, jprior, jcfg = scene
    phys = phys_model_from_reference(jphys)
    cfg = dataclasses.replace(sim_config_from_reference(jcfg), use_fused_render=fused)
    bs = 4
    sim = LensSimulator(phys, cfg, bs=bs, device="cpu")
    members = phys.lenses[1]
    members.set_grid(sim.img_x, sim.img_y)
    assert (sim._use_fused and sim._fused_spec is not None) == fused
    z = np.asarray(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(4), bs)))
    jsim = JLensSimulator(jphys, jcfg, bs=bs)
    jimg = np.asarray(jax.jit(lambda zz: jsim.simulate(jprior.constrain(zz)))(jnp.asarray(z)))
    img = sim.simulate(prior_from_reference(jprior).constrain(torch.tensor(z)))
    _close(img, jimg, 1e-4)

    obs = jimg[0] + np.random.default_rng(0).normal(size=jimg[0].shape).astype(np.float32) * 0.1
    jprob, prob = _probs(jprior, obs)
    zt = torch.tensor(z, requires_grad=True)
    lp, chi = prob.log_prob(sim, zt)
    (grad,) = torch.autograd.grad(lp.sum(), zt)
    jlp, jchi = jax.jit(lambda zz: jprob.log_prob(jsim, zz))(jnp.asarray(z))
    jg = jax.jit(jax.grad(lambda zz: jnp.sum(jprob.log_prob(jsim, zz)[0])))(jnp.asarray(z))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(chi.detach().numpy(), np.asarray(jchi), rtol=1e-4, atol=1e-6)
    jg = np.asarray(jg)
    scale = np.abs(jg).max(1, keepdims=True)
    assert np.isfinite(grad.numpy()).all() and (scale > 0).all()
    np.testing.assert_allclose(grad.numpy() / scale, jg / scale, rtol=1e-4, atol=1e-4)
    assert members.grid_checks == 0  # the simulator's own grid: known by identity


def test_interop_carries_a_set_series_with_jax_coefficients(scene):
    """The port's DPIESubhaloSeries from interop holds JAX's constants,
    expansion point and coefficients (deriv and hessian) and evaluates the
    series on its own grid as JAX does."""
    jphys, _, jcfg = scene
    jm = jphys.lenses[1]
    jm.set_hessian()
    tm = phys_model_from_reference(jphys).lenses[1]
    assert type(tm) is DPIESubhaloSeries and isinstance(tm, ScalingRelationSeries)
    assert tm.order == 3 and tm._rel.chunk_size == CHUNK and tm.n_galaxy == G
    assert float(tm.series_var_0) == 1.5 and float(tm._constants_dict["r_core"]) == np.float32(0.08)
    np.testing.assert_array_equal(tm._deriv_coefs.numpy(), np.asarray(jm._deriv_coefs))
    np.testing.assert_array_equal(tm._hessian_coefs.numpy(), np.asarray(jm._hessian_coefs))
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(jcfg),
                        bs=2, device="cpu")
    tm.set_grid(sim.img_x, sim.img_y)
    kw = dict(theta_E=np.array([0.3, 0.4], np.float32), r_cut=np.array([1.45, 1.6], np.float32))
    for fn in ("deriv", "hessian"):
        got = getattr(tm, fn)(sim.img_x, sim.img_y, **_t(kw))
        want = getattr(jm, fn)(jm._x, jm._y, **_j(kw))
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


def test_map_step_reads_the_grid_once(scene):
    """A MAP run on the builder tier (plain twins on the CPU) compares the
    phase simulator's grid with the series grid once and reuses the padded
    coefficient grid: no per-step comparison (on the card each would be a
    device-to-host read)."""
    jphys, jprior, jcfg = scene
    phys = phys_model_from_reference(jphys)
    cfg = dataclasses.replace(sim_config_from_reference(jcfg), use_fused_render=True)
    members = phys.lenses[1]
    probe = LensSimulator(phys, cfg, bs=1, device="cpu")
    members.set_grid(probe.img_x, probe.img_y)
    obs = np.asarray(jax.jit(JLensSimulator(jphys, jcfg, bs=1).simulate)(
        jprior.sample(jax.random.PRNGKey(1), 1)))
    _, prob = _probs(jprior, obs, positions=False)
    seq = ModellingSequence(phys, prob, cfg, device="cpu")
    seq.MAP(map_optimizer(3), n_samples=4, num_steps=3, seed=0)
    assert members.grid_checks == 1
    grid = seq._sim(4)._fused_spec.gather_extras(seq._sim(4).img_x, seq._sim(4).img_y)[0]
    seq.MAP(map_optimizer(3), n_samples=4, num_steps=3, seed=1)
    assert members.grid_checks == 1
    assert seq._sim(4)._fused_spec.gather_extras(seq._sim(4).img_x, None)[0] is grid


def test_interop_maps_every_cluster_profile():
    """``phys_model_from_reference`` carries DPIS, DPIE, DPIEP,
    DPIESubhalo, a set MassSeries and a set ScalingRelationSeries by
    class name, and each port deflects as its JAX original (the series on
    JAX's coefficients, bound to the port's grid)."""
    from gigalens_tpu.profiles.mass.series import ScalingRelationSeries as JScalingRelationSeries

    cat = _catalogue()
    consts = dict(r_cut=1.6, r_core=0.1, center_x=0.1, center_y=-0.05, e1=0.1, e2=-0.08)
    x, y = _coords(200, seed=16)
    jm = JMassSeries(jdpie.DPIE(), "r_cut", "theta_E", order=2)
    js = JScalingRelationSeries(jdpie.DPIE(), "r_cut", "theta_E", ["theta_E", "r_core", "r_cut"],
                                1.0, {"theta_E": 0.5, "r_core": 0.5, "r_cut": 0.5}, cat, order=2,
                                chunk_size=CHUNK)
    for series, c in ((jm, consts), (js, dict(r_cut=1.5, r_core=0.08))):
        series.set_constants(c)
        series.set_grid(jnp.asarray(x), jnp.asarray(y))
        series.set_deriv()
    jlenses = [jdpie.DPIS(), jdpie.DPIE(), jdpie.DPIEP(),
               JDPIESubhalo(lum_star=1.0, galaxy_catalogue=cat, chunk_size=CHUNK), jm, js]
    lenses = phys_model_from_reference(JPhysicalModel(jlenses, [], [])).lenses
    assert [type(t).__name__ for t in lenses] == [type(j).__name__ for j in jlenses]
    xt, yt = torch.tensor(x), torch.tensor(y)
    for name in ("DPIS", "DPIE", "DPIEP"):
        prof = lenses[[type(t).__name__ for t in lenses].index(name)]
        p = _draw(PROFILES[name][2], seed=17)
        for g, w in zip(prof.deriv(xt, yt, **_t(p)),
                        jlenses[lenses.index(prof)].deriv(jnp.asarray(x), jnp.asarray(y), **_j(p))):
            _close(g, w, PROFILES[name][3])
    for g, w in zip(lenses[3].deriv(xt, yt, **_t(SCALES)),
                    jlenses[3].deriv(jnp.asarray(x), jnp.asarray(y), **_j(SCALES))):
        _close(g, w, 1e-4)
    kw = dict(theta_E=np.array([0.8, 0.5], np.float32), r_cut=np.array([1.55, 1.7], np.float32))
    for port, ref in ((lenses[4], jm), (lenses[5], js)):
        port.set_grid(xt, yt)
        for g, w in zip(port.deriv(xt, yt, **_t(kw)), ref.deriv(ref._x, ref._y, **_j(kw))):
            _close(g, w, 1e-5)
