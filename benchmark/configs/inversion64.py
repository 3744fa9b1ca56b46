"""``inversion64`` on the program: ``PixelatedSourceProbModel`` over [SIE,
Shear] with a pixelated source and a sampled ``lam``, its simulator at the
traffic's batch, and the shapes of the work a MAP step does."""
from __future__ import annotations

from configs._port import port_prior, sim_config, supersampled_psf_size


def build(cfg, obs, bs, device):
    """(prob_model, simulator) of the program for the (H, W) float32 data
    ``obs`` at ``bs`` rows on ``device``."""
    from gigalens_tpu_torch import PhysicalModel
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid
    from gigalens_tpu_torch.profiles.mass import SIE, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    g = cfg["source_grid"]
    prob = PixelatedSourceProbModel(port_prior(cfg["prior"]), obs.cpu().numpy(),
                                    background_rms=cfg["background_rms"],
                                    exp_time=cfg["exp_time"],
                                    grid=SourceGrid(g["n_side"], g["extent"]), lam=None,
                                    device=device)
    phys = PhysicalModel([SIE(), Shear()], [], [])
    return prob, LensSimulator(phys, sim_config(cfg), bs=bs, device=device)


def shapes(cfg, traffic):
    """The work of one MAP step by layer, for the per-layer metrics."""
    bs, ss, n = traffic["starts"], cfg["supersample"], cfg["num_pix"]
    n_src = cfg["source_grid"]["n_side"] ** 2
    k = supersampled_psf_size(cfg)
    side = n * ss
    return {
        "k4": {"images": n_src * bs, "h": side, "w": side, "kh": k, "kw": k, "pool": ss},
        "gram": {"rows": bs, "n_src": n_src, "pixels": n * n},
        "mapping": {"rows": bs, "n_src": n_src, "pixels": side * side},
    }
