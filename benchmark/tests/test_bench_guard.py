"""The run's guard against JAX: top-level module names compared whole, so
the program (``gigalens_tpu_torch``) is told apart from the JAX package
(``gigalens_tpu``); and the scan of the reference files' imports."""
import sys
import types

import harness


def test_program_modules_are_not_taken_for_the_jax_package(monkeypatch):
    for name in ("gigalens_tpu_torch", "gigalens_tpu_torch.ops.cuda", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == []


def test_the_jax_package_jax_and_flax_are_found(monkeypatch):
    for name in ("gigalens_tpu.profiles", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == ["flax", "gigalens_tpu", "jaxlib"]


def test_a_run_loads_no_jax():
    import gigalens_tpu_torch  # noqa: F401  the program, as a run loads it

    assert harness.banned_modules() == []


def test_reference_files_import_neither_the_program_nor_jax(tmp_path, monkeypatch):
    assert harness.reference_imports_program() == []
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "good.py").write_text("import torch\nfrom reference.plain import Blur\n")
    (ref / "bad.py").write_text("def f():\n    from gigalens_tpu_torch.ops import psf\n")
    (ref / "worse.py").write_text("import jax.numpy as jnp\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    assert harness.reference_imports_program() == ["bad.py", "worse.py"]
