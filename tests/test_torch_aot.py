"""The port's cache keys (gigalens_tpu_torch/utils/aot.py) against the JAX
package's contract (tests/test_aot.py:32-92): a stale artifact is silently
wrong, so the data fingerprint must tell apart everything an artifact
depends on (schedule constants in closure cells, array content and dtype,
object graphs) and give the same key in every process; and the kernel
library's name (ops/cuda/_build.py) must change with the toolchain that
builds it and the CUDA version torch was built with.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer
from gigalens_tpu_torch.ops.cuda import _build
from gigalens_tpu_torch.utils import aot

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.quick
def test_fingerprint_sees_schedule_constants():
    """Two optimizers from the same code with other constants differ: the
    constants live in closure cells, not in the package's source."""
    a = aot.data_fingerprint(map_optimizer(100, lr=1e-2))
    assert a == aot.data_fingerprint(map_optimizer(100, lr=1e-2))
    assert a != aot.data_fingerprint(map_optimizer(100, lr=3e-3))
    assert a != aot.data_fingerprint(map_optimizer(200, lr=1e-2))
    assert a != aot.data_fingerprint(svi_optimizer(100))


def test_fingerprint_is_process_stable():
    """The same objects hash alike in another process: a tree of tensors,
    arrays and scalars, and an optimizer (no address or id enters)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, torch\n"
        "from gigalens_tpu_torch.inference.sequence import map_optimizer\n"
        "from gigalens_tpu_torch.utils import aot\n"
        "tree = dict(a=[torch.arange(4.0), np.ones(3, np.float32)], b=dict(c=2, d='x'))\n"
        "print(aot.data_fingerprint(tree, map_optimizer(7)), aot.package_fingerprint())\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    tree = dict(a=[torch.arange(4.0), np.ones(3, np.float32)], b=dict(c=2, d="x"))
    assert out.stdout.split() == [aot.data_fingerprint(tree, map_optimizer(7)),
                                  aot.package_fingerprint()]


def test_fingerprint_sees_array_content():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = x.copy()
    y[1, 2] += 1e-6
    assert aot.data_fingerprint(x) == aot.data_fingerprint(x.copy())
    assert aot.data_fingerprint(x) != aot.data_fingerprint(y)
    assert aot.data_fingerprint(x) != aot.data_fingerprint(x.astype(np.float64))
    t = torch.from_numpy(x)
    # a tensor hashes as its content: its numpy twin's key, whatever its device
    assert aot.data_fingerprint(t) == aot.data_fingerprint(x)
    assert aot.array_fingerprint(t) == aot.array_fingerprint(x)
    assert aot.array_fingerprint(t) != aot.array_fingerprint(torch.from_numpy(y))
    assert aot.data_fingerprint(t) != aot.data_fingerprint(t.reshape(3, 2))


def test_fingerprint_object_graphs():
    """Prob models and simulators: other observed data is another key; the
    same objects the same key."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as dist
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import SIE, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    prior = Prior(dict(lens_mass=[dict(theta_E=dist.LogNormal(0.0, 0.1)), dict()],
                       source_light=[dict(Ie=dist.LogNormal(0.0, 0.1))]))
    obs = np.zeros((20, 20), np.float32)
    pm1 = ForwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0, device="cpu")
    pm2 = ForwardProbModel(prior, obs + 0.1, background_rms=0.1, exp_time=100.0, device="cpu")
    phys = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
    sim = LensSimulator(phys, SimulatorConfig(delta_pix=0.1, num_pix=20), bs=4, device="cpu")
    assert aot.data_fingerprint(pm1, sim) != aot.data_fingerprint(pm2, sim)
    assert aot.data_fingerprint(pm1, sim) == aot.data_fingerprint(pm1, sim)
    assert aot.phase_desc(pm1, sim, extra="8") == aot.data_fingerprint(pm1, sim) + "|8"


def test_phase_desc_declines_a_mesh_and_the_unhashable():
    from gigalens_tpu_torch.parallel import Mesh

    mesh = Mesh("cpu")
    mesh.size = 2
    assert aot.phase_desc(np.ones(2), mesh=mesh) is None
    assert aot.phase_desc(np.array([object()], dtype=object)) is None


def test_library_name_follows_the_toolchain(monkeypatch):
    """The kernel library's name changes with what ``nvcc --version``
    reports, with ``torch.version.cuda`` and with the platform; the same
    toolchain gives the same name."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    release = "Cuda compilation tools, release 12.4, V12.4.131"
    monkeypatch.setattr(_build, "_nvcc_version", lambda nvcc: release)
    monkeypatch.setattr(torch.version, "cuda", "12.4")
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "_nvcc_version",
                        lambda nvcc: "Cuda compilation tools, release 12.6, V12.6.85")
    other_nvcc = _build.library_path()
    monkeypatch.setattr(_build, "_nvcc_version", lambda nvcc: release)
    monkeypatch.setattr(torch.version, "cuda", "12.6")
    other_cuda = _build.library_path()
    monkeypatch.setattr(torch.version, "cuda", "12.4")
    monkeypatch.setattr(aot, "platform_fingerprint", lambda: "aarch64|Linux")
    other_platform = _build.library_path()
    assert len({first, other_nvcc, other_cuda, other_platform}) == 4
