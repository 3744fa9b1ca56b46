"""Phase checkpointing for the inference pipeline (port of
:mod:`gigalens_tpu.utils.checkpoint`).

Each phase result is written as a plain ``.npz`` file with the JAX
package's keys, so either package loads the other's files, and a rerun
of the pipeline skips the phases already saved. ``load_*`` return the
port's types on ``device`` (``None``: the CUDA card; the CPU only when
asked for by name).
"""
from __future__ import annotations

import os

import numpy as np
import torch

import gigalens_tpu_torch.model as gmodel
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensors(device, *arrays):
    device = gmodel.resolve_device(device)
    return tuple(torch.as_tensor(np.array(a), device=device) for a in arrays)


def save_map(path: str, z, chi2_history=None):
    np.savez(path, z=_np(z),
             chi2_history=_np(chi2_history) if chi2_history is not None else np.zeros(0))


def load_map(path: str, device=None):
    with np.load(path) as d:
        return _tensors(device, d["z"], d["chi2_history"])


def save_svi(path: str, q_z: MultivariateNormalTriL, losses=None):
    np.savez(path, loc=_np(q_z.loc), scale_tril=_np(q_z.scale_tril),
             losses=_np(losses) if losses is not None else np.zeros(0))


def load_svi(path: str, device=None):
    with np.load(path) as d:
        loc, tril, losses = _tensors(device, d["loc"], d["scale_tril"], d["losses"])
    return MultivariateNormalTriL(loc, tril), losses


def save_hmc(path: str, result):
    np.savez(path, samples=_np(result.samples), accept_rate=_np(result.accept_rate),
             step_size=_np(result.step_size), final_state=_np(result.final_state),
             trajectory_length=_np(result.trajectory_length),
             divergences=_np(result.divergences))


def load_hmc(path: str, device=None):
    """An :class:`~gigalens_tpu_torch.inference.hmc.HMCResult`. The files
    carry no leapfrog count (the JAX package writes none), so
    ``total_leapfrogs`` is 0 on a loaded result. Older files without
    ``trajectory_length`` or ``divergences`` load with a 0-d zero and
    per-chain zeros."""
    from gigalens_tpu_torch.inference.hmc import HMCResult

    with np.load(path) as d:
        traj = d["trajectory_length"] if "trajectory_length" in d else np.zeros((), np.float32)
        # pre-divergence-field files: per-chain zeros, not a 0-d default
        # (consumers reshape per scene / sum per chain)
        div = (d["divergences"] if "divergences" in d
               else np.zeros((d["samples"].shape[1],), np.int32))
        arrays = _tensors(device, d["samples"], d["accept_rate"], d["step_size"],
                          d["final_state"], traj, div)
    return HMCResult(*arrays, total_leapfrogs=0)


def save_smc(path: str, result):
    np.savez(path, particles=_np(result.particles), num_stages=np.asarray(result.num_stages),
             log_scalings=_np(result.log_scalings), post_samples=_np(result.post_samples),
             final_beta=_np(result.final_beta), log_evidence=_np(result.log_evidence))


def load_smc(path: str, device=None):
    """An :class:`~gigalens_tpu_torch.inference.smc.SMCResult`; an older
    file without ``log_evidence`` loads with a 0-d zero."""
    from gigalens_tpu_torch.inference.smc import SMCResult

    with np.load(path) as d:
        lz = d["log_evidence"] if "log_evidence" in d else np.zeros((), np.float32)
        particles, scalings, post, beta, lz = _tensors(
            device, d["particles"], d["log_scalings"], d["post_samples"], d["final_beta"], lz)
        num_stages = int(d["num_stages"])
    return SMCResult(particles, num_stages, scalings, post, beta, lz)


class PipelineCheckpointer:
    """Resumable MAP -> SVI -> HMC (/ SMC) runner: each ``run_*`` loads
    the phase's saved result if there is one, else runs ``fn`` and saves
    what it returns. Loaded results go to ``device`` (``None``: the CUDA
    card).

    Under a ``mesh`` (:mod:`gigalens_tpu_torch.parallel`) rank 0 decides
    whether a phase is saved and writes its file, and every rank goes on
    after a barrier, so a rerun skips the same phases on every rank. A
    phase that runs returns each rank's own result, which is the global
    one on every rank."""

    def __init__(self, directory: str, device=None, mesh=None):
        self.dir = directory
        self.device = gmodel.resolve_device(device)
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    def _p(self, name):
        return os.path.join(self.dir, f"{name}.npz")

    def has(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def _run(self, name, fn, save, load):
        saved = torch.tensor([self.has(name)], dtype=torch.float32, device=self.device)
        if bool(pmesh.replicate(saved, self.mesh)):  # rank 0's answer on every rank
            return load(self._p(name), self.device)
        out = fn()
        if self.mesh is None or self.mesh.rank == 0:
            save(self._p(name), out)
        pmesh.barrier(self.mesh)  # the file is whole before any rank goes on
        return out

    def run_map(self, fn):
        return self._run("map", fn, lambda p, out: save_map(p, *out), load_map)

    def run_svi(self, fn):
        return self._run("svi", fn, lambda p, out: save_svi(p, *out), load_svi)

    def run_hmc(self, fn):
        return self._run("hmc", fn, save_hmc, load_hmc)

    def run_smc(self, fn):
        return self._run("smc", fn, save_smc, load_smc)
