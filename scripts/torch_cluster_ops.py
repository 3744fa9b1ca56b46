"""Counts the PyTorch operations of one cluster log-density with its gradient.

The cluster scene of chip_smoke.py's cluster phase (config #5, dpie arm:
NFW_ELLIPSE halo, 20 DPIESubhaloSeries members, Shapelets(4) source, 48 px
at 0.2", supersample 2), pixels alone and pixels + the image positions of
its truth (``find_images``), at a small batch, with every operation counted as it is
dispatched (``TorchDispatchMode``). On the card each counted elementwise
operation is about one kernel launch, so the count is the host work of a
MAP step or an SMC leapfrog. The render is the unfused one here (the
series by one matmul), so K5/K7 do not inflate the count on the CPU.

Two evaluations of the positions term's Hessian are counted:
* ``port``: as the port runs it (closed-form dPIE and NFW_ELLIPSE
  Hessians, the members summed in one pass at few points);
* ``forward``: as the JAX package evaluates it (forward mode through each
  profile's ``deriv``, the members chunk by chunk).

    python3 scripts/torch_cluster_ops.py [--bs 16] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from chip_smoke import CL_BKG, CL_CONSTS, CL_EXP_TIME, CL_POS_ERR, cluster_scene  # noqa: E402
from gigalens_tpu_torch.model import ForwardProbModel  # noqa: E402
from gigalens_tpu_torch.profiles.base import MassProfile  # noqa: E402
from gigalens_tpu_torch.profiles.mass import DPIE, NFW_ELLIPSE, scaling  # noqa: E402
from gigalens_tpu_torch.simulator import LensSimulator  # noqa: E402
from gigalens_tpu_torch.utils import find_images  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    dev = torch.device(a.device)
    phys, prior, cfg, members = cluster_scene()
    cfg = dataclasses.replace(cfg, use_fused_render=False, psf_mode="fft")
    sim = LensSimulator(phys, cfg, bs=a.bs, device=dev)
    members.set_constants(CL_CONSTS)
    members.set_grid(sim.img_x, sim.img_y)
    members.set_deriv()
    truth = prior.sample(torch.Generator(device=dev).manual_seed(5), 1)
    probe = LensSimulator(phys, cfg, bs=1, device=dev)
    with torch.no_grad():
        obs = probe.simulate(truth).cpu().numpy()
    src = truth["source_light"][0]
    ix, iy, _ = find_images(probe, truth["lens_mass"], float(src["center_x"][0]),
                            float(src["center_y"][0]), search_window=4.0)
    err = np.full(len(ix), CL_POS_ERR, np.float32)
    z0 = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(1), a.bs))
    print(f"cluster scene: bs {a.bs}, {sim.img_x.shape[0]} px, {len(ix)} image positions, "
          f"device {dev}")
    for mode in ("port", "forward"):
        saved = DPIE.hessian, NFW_ELLIPSE.hessian, scaling.ONE_PASS_ELEMENTS
        if mode == "forward":
            DPIE.hessian = NFW_ELLIPSE.hessian = MassProfile.hessian
            scaling.ONE_PASS_ELEMENTS = 0
        try:
            for positions in (False, True):
                kw = dict(centroids_x=[ix], centroids_y=[iy], centroids_errors_x=[err],
                          centroids_errors_y=[err]) if positions else {}
                prob = ForwardProbModel(prior, obs, background_rms=CL_BKG,
                                        exp_time=CL_EXP_TIME, device=dev, **kw)
                z = z0.clone().requires_grad_(True)
                with Count() as c:
                    lp, _ = prob.log_prob(sim, z)
                    torch.autograd.grad(lp.sum(), z)
                with Count() as h:
                    with torch.no_grad():
                        sim.hessian(torch.as_tensor(ix, device=dev),
                                    torch.as_tensor(iy, device=dev),
                                    prior.constrain(z0)["lens_mass"])
                print(f"{mode:8s} {'pixels + positions' if positions else 'pixels':18s}: "
                      f"{sum(c.ops.values()):6d} operations a log-density with gradient "
                      f"(the positions' Hessian alone {sum(h.ops.values())})", flush=True)
        finally:
            DPIE.hessian, NFW_ELLIPSE.hessian, scaling.ONE_PASS_ELEMENTS = saved


if __name__ == "__main__":
    main()
