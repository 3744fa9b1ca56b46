"""Plain PyTorch pieces the configurations' references are built from.

Written from the published equations, in whatever dtype the caller's
tensors have (float64 for the reference; the lower-precision control runs
the same code in float32 with its products rounded to TF32, ``Precision``).
Nothing here imports the program under test: a reference re-derives every
table it needs (the supersampled PSF, the pooled kernel, the coordinate
grid, the regularizer) from the configuration's own numbers.

* priors: Normal, LogNormal, Uniform, TruncatedNormal, their unconstraining
  bijectors (identity, exp, sigmoid), sampling, and the column order of the
  unconstrained vector (sorted dict keys, lists in order);
* lenses: EPL (Tessore & Metcalf 2015, angular series of ``niter`` terms),
  SIE (Kormann et al. 1994), external shear;
* light: elliptical Sersic, Cartesian shapelets (Hermite recurrence);
* the image: a centred supersampled grid, the PSF resampled onto it
  (flux-conserving bilinear subgrid), 'SAME' convolution, mean pooling;
* the pseudo-inverse with the Golub-Pereyra derivative, and Adam under a
  polynomial step-size schedule.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


class Precision:
    """How a reference runs: ``"float64"`` (the reference itself);
    ``"float32"``, the configuration's own precision (float32 tensors, TF32
    off, and what the configuration states in float64 in float64), a
    yardstick for float32 rounding; or ``"tf32"``, the control, one step of
    precision below the configuration's: float32 tensors whose matrix
    products and convolutions round both operands to TF32 (10 mantissa bits,
    round to nearest) and accumulate in float32, and what the configuration
    states in float64 in float32."""

    def __init__(self, mode: str):
        if mode not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "float64" else torch.float32
        # the dtype of what the configuration states in float64
        self.wide = torch.float32 if mode == "tf32" else torch.float64

    def round(self, x):
        """``x`` as the products see it."""
        if self.mode != "tf32":
            return x
        return _RoundTF32.apply(x)

    def matmul(self, a, b):
        return torch.matmul(self.round(a), self.round(b))


def tf32_round(x):
    """float32 ``x`` rounded to the nearest TF32 value (ties away from zero,
    as the tensor cores' conversion), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding whose derivative rounds the cotangent too: the
    backward's products see TF32 operands as the forward's do."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

def _softplus(z):
    return torch.logaddexp(z, torch.zeros_like(z))


def _ndtr(x):
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


class Dist:
    """One scalar prior from its configuration entry ``[family, *numbers]``."""

    def __init__(self, spec):
        self.family, *nums = spec
        self.nums = [float(v) for v in nums]
        if self.family == "TruncatedNormal":
            loc, scale, low, high = self.nums
            a, b = (low - loc) / scale, (high - loc) / scale
            self.log_z = math.log(_ndtr(b) - _ndtr(a))
            self.cdf = (_ndtr(a), _ndtr(b))
        elif self.family not in ("Normal", "LogNormal", "Uniform"):
            raise ValueError(f"no plain prior for {self.family!r}")

    def log_prob(self, x):
        f, n = self.family, self.nums
        if f == "Normal":
            loc, scale = n
            return -0.5 * (((x - loc) / scale) ** 2 + LOG_2PI) - math.log(scale)
        if f == "LogNormal":
            loc, scale = n
            lx = torch.log(x)
            return -0.5 * (((lx - loc) / scale) ** 2 + LOG_2PI) - math.log(scale) - lx
        if f == "Uniform":
            low, high = n
            return torch.zeros_like(x) - math.log(high - low)
        loc, scale, low, high = n
        return -0.5 * (((x - loc) / scale) ** 2 + LOG_2PI) - math.log(scale) - self.log_z

    def interval(self):
        return self.nums[-2:] if self.family in ("Uniform", "TruncatedNormal") else None

    def forward(self, z):
        """Unconstrained -> constrained."""
        if self.family == "LogNormal":
            return torch.exp(z)
        iv = self.interval()
        if iv is None:
            return z
        return iv[0] + (iv[1] - iv[0]) * torch.sigmoid(z)

    def inverse(self, x):
        if self.family == "LogNormal":
            return torch.log(x)
        iv = self.interval()
        if iv is None:
            return x
        u = (x - iv[0]) / (iv[1] - iv[0])
        return torch.log(u) - torch.log1p(-u)

    def fldj(self, z):
        if self.family == "LogNormal":
            return z
        iv = self.interval()
        if iv is None:
            return torch.zeros_like(z)
        return math.log(iv[1] - iv[0]) - _softplus(-z) - _softplus(z)

    def sample(self, gen, n):
        """``n`` float64 draws from ``gen`` (on its device)."""
        f, nums = self.family, self.nums
        dev = gen.device
        if f in ("Normal", "LogNormal"):
            eps = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
            x = nums[0] + nums[1] * eps
            return torch.exp(x) if f == "LogNormal" else x
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        if f == "Uniform":
            return nums[0] + (nums[1] - nums[0]) * u
        lo, hi = self.cdf
        u = lo + (hi - lo) * (1e-7 + (1.0 - 2e-7) * u)
        x = nums[0] + nums[1] * torch.special.ndtri(u)
        return torch.clamp(x, nums[2], nums[3])


class PlainPrior:
    """A joint prior from the configuration's tree ``{group: [{param:
    spec}]}``: columns in sorted-key order at every level, lists in order."""

    def __init__(self, tree):
        self.tree = tree
        self.columns = []  # (group, index, param, Dist)
        for group in sorted(tree):
            for i, prof in enumerate(tree[group]):
                for name in sorted(prof):
                    self.columns.append((group, i, name, Dist(prof[name])))
        self.d = len(self.columns)

    def constrain(self, z):
        """(n, d) -> {group: [{param: (n,)}]}."""
        out = {g: [dict() for _ in ps] for g, ps in self.tree.items()}
        for j, (g, i, name, dist) in enumerate(self.columns):
            out[g][i][name] = dist.forward(z[:, j])
        return out

    def log_prob_z(self, z):
        """log p(constrain(z)) + log |d constrain / dz|, (n,)."""
        total = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for j, (_, _, _, dist) in enumerate(self.columns):
            zj = z[:, j]
            total = total + dist.log_prob(dist.forward(zj)) + dist.fldj(zj)
        return total

    def sample_z(self, gen, n):
        """(n, d) float64 unconstrained prior draws from ``gen``."""
        cols = [dist.inverse(dist.sample(gen, n)) for (_, _, _, dist) in self.columns]
        return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# lenses and light (parameters (n, 1) against coordinates (P,))
# ---------------------------------------------------------------------------

def polar(e1, e2, e_max):
    """(q, phi) of an ellipticity pair, phi = atan2(e2, e1) / 2."""
    e = torch.clamp(torch.sqrt(e1**2 + e2**2), max=e_max)
    return (1 - e) / (1 + e), torch.atan2(e2, e1) / 2


def rotate(x, y, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    return x * c + y * s, -x * s + y * c


def epl_deflection(x, y, p, niter):
    """EPL (theta_E, gamma, e1, e2, center_x, center_y): the angular series
    of Tessore & Metcalf (2015) truncated at ``niter`` terms."""
    q, phi = polar(p["e1"], p["e2"], 1.0)
    b = p["theta_E"] * torch.sqrt(q)
    t = p["gamma"] - 1
    xr, yr = rotate(x - p["center_x"], y - p["center_y"], phi)
    R = torch.clamp(torch.sqrt((q * xr) ** 2 + yr**2), 1e-10, 1e10)
    ct, st = q * xr / R, yr / R
    c2, s2 = ct * ct - st * st, 2 * ct * st
    f = (1 - q) / (1 + q)
    ax, ay, ox, oy = ct, st, ct, st
    for n in range(1, niter):
        ratio = -f * (2 * n - (2 - t)) / (2 * n + (2 - t))
        ax, ay = ratio * (c2 * ax - s2 * ay), ratio * (s2 * ax + c2 * ay)
        ox, oy = ox + ax, oy + ay
    pref = 2 * b / (1 + q) * torch.exp((t - 1) * torch.log(b / R))
    return rotate(pref * ox, pref * oy, -phi)


def sie_deflection(x, y, p):
    """Singular isothermal ellipsoid (theta_E, e1, e2, center_x, center_y),
    Kormann et al. (1994), intermediate-axis normalisation."""
    q, phi = polar(p["e1"], p["e2"], 0.9999)
    b = p["theta_E"] * torch.sqrt(q)
    xr, yr = rotate(x - p["center_x"], y - p["center_y"], phi)
    psi = torch.sqrt(q**2 * xr**2 + yr**2)
    root = torch.sqrt(torch.clamp(1 - q**2, min=1e-10))
    fx = b / root * torch.arctan(root * xr / psi)
    fy = b / root * torch.arctanh(root * yr / psi)
    return rotate(fx, fy, -phi)


def shear_deflection(x, y, p):
    g1, g2 = p["gamma1"], p["gamma2"]
    return g1 * x + g2 * y, g2 * x - g1 * y


def sersic_ellipse(x, y, p):
    """Unit-amplitude elliptical Sersic (R_sersic, n_sersic, e1, e2,
    center_x, center_y): b_n = 1.9992 n - 0.3271 (Ciotti & Bertin)."""
    c = torch.sqrt(p["e1"] ** 2 + p["e2"] ** 2)
    q, phi = (1 - c) / (1 + c), torch.atan2(p["e2"], p["e1"]) / 2
    dx, dy = x - p["center_x"], y - p["center_y"]
    x1 = (torch.cos(phi) * dx + torch.sin(phi) * dy) * torch.sqrt(q)
    x2 = (-torch.sin(phi) * dx + torch.cos(phi) * dy) / torch.sqrt(q)
    R = torch.sqrt(x1**2 + x2**2)
    n = p["n_sersic"]
    return torch.exp(-(1.9992 * n - 0.3271) * ((R / p["R_sersic"]) ** (1.0 / n) - 1.0))


def shapelet_basis(x, y, p, n_max):
    """The (n_max + 1)(n_max + 2) / 2 Cartesian shapelets (beta, center_x,
    center_y) in triangular order (n1, n2) = (0, 0), (1, 0), (0, 1), (2, 0),
    (1, 1), (0, 2), ...; each phi_n1(u) phi_n2(v) exp(-(u^2 + v^2) / 2)
    with phi_n = H_n / sqrt(2^n sqrt(pi) n!). Returns a list of images."""
    u = (x - p["center_x"]) / p["beta"]
    v = (y - p["center_y"]) / p["beta"]

    def herm(w):
        hs = [torch.ones_like(w), 2 * w]
        for n in range(1, n_max):
            hs.append(2 * (w * hs[n] - n * hs[n - 1]))
        return [h / math.sqrt(2.0**k * math.sqrt(math.pi) * math.factorial(k))
                for k, h in enumerate(hs[:n_max + 1])]

    hu, hv = herm(u), herm(v)
    g = torch.exp(-(u**2 + v**2) / 2)
    out = []
    for total in range(n_max + 1):
        for n2 in range(total + 1):
            out.append(g * hu[total - n2] * hv[n2])
    return out


# ---------------------------------------------------------------------------
# the image
# ---------------------------------------------------------------------------

def pixel_grid(num_pix, delta_pix, supersample, dtype, device):
    """(x, y), each (P,), of the supersampled grid, row-major, centred so
    that the mean coordinate is 0."""
    n = num_pix * supersample
    step = delta_pix / supersample
    c = (torch.arange(n, dtype=torch.float64) - (n - 1) / 2.0) * step
    Y, X = torch.meshgrid(c, c, indexing="ij")
    return (X.reshape(-1).to(dtype=dtype, device=device),
            Y.reshape(-1).to(dtype=dtype, device=device))


def _bilinear(kernel, factor):
    n = kernel.shape[0]
    m = factor * n + (1 - (factor * n) % 2)  # the odd size at or above factor * n
    coords = (np.arange(m) - (m - 1) / 2.0) / factor + (n - 1) / 2.0
    x0 = np.clip(np.floor(coords).astype(int), 0, n - 2)
    w = np.clip(coords - x0, 0.0, 1.0)
    rows = kernel[x0, :] * (1 - w)[:, None] + kernel[x0 + 1, :] * w[:, None]
    return rows[:, x0] * (1 - w)[None, :] + rows[:, x0 + 1] * w[None, :]


def _block_sum(kernel, factor):
    m = kernel.shape[0]
    n = -(-m // factor)
    pad = n * factor - m
    kernel = np.pad(kernel, ((pad // 2, pad - pad // 2),) * 2)
    return kernel.reshape(n, factor, n, factor).sum(axis=(1, 3))


def subgrid_psf(kernel, factor, num_iter=5):
    """A native-pixel PSF resampled onto a ``factor``-times finer odd grid,
    flux-conserving: bilinear interpolation, then ``num_iter`` corrections
    so that block sums reproduce the native kernel (float64)."""
    kernel = np.asarray(kernel, np.float64)
    kernel = kernel / kernel.sum()
    if factor == 1:
        return kernel
    fine = np.clip(_bilinear(kernel, factor), 0, None)
    fine /= fine.sum()
    n = kernel.shape[0]
    for _ in range(num_iter):
        coarse = _block_sum(fine, factor)
        trim = (coarse.shape[0] - n) // 2
        coarse = coarse[trim:trim + n, trim:trim + n]
        corr = _bilinear(kernel / np.maximum(coarse, 1e-12), factor)
        t = (corr.shape[0] - fine.shape[0]) // 2
        corr = corr[t:t + fine.shape[0], t:t + fine.shape[0]]
        fine = np.clip(fine * corr, 0, None)
        fine /= fine.sum()
    return fine


class Blur:
    """'SAME' convolution with an odd PSF, then the ``pool`` x ``pool`` mean
    (an image's flux per native pixel), of (..., H, W) images."""

    def __init__(self, psf, pool, precision: Precision, device):
        k = torch.as_tensor(np.ascontiguousarray(psf[::-1, ::-1]), dtype=precision.dtype,
                            device=device)
        self.weight = k[None, None]
        self.pad = psf.shape[0] // 2
        self.pool = pool
        self.precision = precision

    def __call__(self, img):
        lead, (h, w) = img.shape[:-2], img.shape[-2:]
        x = self.precision.round(img.reshape(-1, 1, h, w))
        out = F.conv2d(x, self.precision.round(self.weight), padding=self.pad)
        out = F.avg_pool2d(out, self.pool)
        return out.reshape(*lead, h // self.pool, w // self.pool)


# ---------------------------------------------------------------------------
# linear algebra and the optimizer
# ---------------------------------------------------------------------------

class _PInv(torch.autograd.Function):
    """Moore-Penrose pseudo-inverse (singular values at or below ``rtol`` of
    the largest dropped), differentiated by Golub and Pereyra's formula
    (SIAM J. Numer. Anal. 10, 413, 1973)."""

    @staticmethod
    def forward(ctx, a, rtol):
        p = torch.linalg.pinv(a, rtol=rtol)
        ctx.save_for_backward(a, p)
        return p

    @staticmethod
    def backward(ctx, g):
        a, p = ctx.saved_tensors
        pt, gt = p.mT, g.mT
        return (-(pt @ g) @ pt + (gt - a @ (p @ gt)) @ (p @ pt)
                + (pt @ p) @ (gt - (gt @ p) @ a)), None


def pinv(a, rtol):
    return _PInv.apply(a, rtol)


def schedule(traffic, count):
    """The step size of the update ``count`` (0-based): a polynomial decay
    from ``lr[0]`` to ``lr[1]`` over the fit's steps, as a negative scale."""
    lr0, lr1 = traffic["lr"]
    frac = 1 - min(max(count, 0), traffic["steps"]) / traffic["steps"]
    return -((lr0 - lr1) * frac ** traffic["power"] + lr1)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) times the traffic's schedule."""

    def __init__(self, traffic, z):
        self.traffic = traffic
        self.mu = torch.zeros_like(z)
        self.nu = torch.zeros_like(z)
        self.count = 0

    def update(self, g):
        b1, b2 = 0.9, 0.999
        self.mu = (1 - b1) * g + b1 * self.mu
        self.nu = (1 - b2) * g * g + b2 * self.nu
        c = self.count + 1
        mu_hat = self.mu / (1 - b1**c)
        nu_hat = self.nu / (1 - b2**c)
        u = mu_hat / (torch.sqrt(nu_hat) + 1e-8) * schedule(self.traffic, self.count)
        self.count = c
        return u
