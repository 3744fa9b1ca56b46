"""``epl80_lstsq`` on the program: ``BackwardProbModel`` over [EPL, Shear] +
[SersicEllipse (lstsq)] + [Shapelets(4) (lstsq)], its simulator at the
traffic's batch, and the shapes of the work a MAP step does."""
from __future__ import annotations

from configs._port import port_prior, sim_config, supersampled_psf_size


def build(cfg, obs, bs, device):
    """(prob_model, simulator) of the program for the (H, W) float32 data
    ``obs`` at ``bs`` rows on ``device``."""
    from gigalens_tpu_torch import PhysicalModel
    from gigalens_tpu_torch.model import BackwardProbModel
    from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
    from gigalens_tpu_torch.profiles.mass import EPL, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    niter = cfg["lens_mass"][0][1]["niter"]
    n_max = cfg["source_light"][0][1]["n_max"]
    phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse(use_lstsq=True)],
                         [Shapelets(n_max, use_lstsq=True)])
    prob = BackwardProbModel(port_prior(cfg["prior"]), obs.cpu().numpy(),
                             background_rms=cfg["background_rms"], exp_time=cfg["exp_time"],
                             device=device)
    return prob, LensSimulator(phys, sim_config(cfg), bs=bs, device=device)


def shapes(cfg, traffic):
    """The work of one MAP step (a log density with its gradient at every
    start, and the update), by layer, for the per-layer metrics."""
    bs, ss, n = traffic["starts"], cfg["supersample"], cfg["num_pix"]
    depth = 1 + (cfg["source_light"][0][1]["n_max"] + 1) * (cfg["source_light"][0][1]["n_max"] + 2) // 2
    k = supersampled_psf_size(cfg)
    side = n * ss
    w = cfg["work"]
    return {
        "k4": {"images": depth * bs, "h": side, "w": side, "kh": k, "kw": k, "pool": ss},
        "render": {"rows": bs, "pixels": side * side, "components": depth,
                   "params": 17, "fwd_ops_per_row_pixel": w["render_fwd_ops_per_row_pixel"],
                   "bwd_ops_per_row_pixel": w["render_bwd_ops_per_row_pixel"]},
        "lstsq": {"rows": bs, "pixels": n * n, "depth": depth},
    }
