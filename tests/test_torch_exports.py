"""What the port exports against what the JAX package exports: for
``llm``, ``rllib``, ``train``, ``parallel``, ``models`` and ``tune``,
every name of the JAX package's ``__all__`` has a counterpart in the
port's ``__all__``, under the same name or under one of the renames
below, of the same kind (a class for a class, a function for a function,
a module for a module, a mapping with the same keys for a mapping). And
no module of the port, nor ``chip_smoke.py`` or
``serve_ab.py``, imports JAX, ``ml_dtypes`` or anything of the JAX
package.
"""

import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("llm", "rllib", "train", "parallel", "models", "tune")
# JAX name -> the port's name, where they differ.
RENAMES = {
    "JaxPolicy": "TorchPolicy",
    "JaxEnv": "DeviceEnv",
    "jax_cartpole": "cartpole",
    "jax_atari_sim": "atari_sim",
    "JAX_ENVS": "ENVS",
    "JaxTrainer": "TorchTrainer",
    "JaxPredictor": "TorchPredictor",
}


def kind(obj):
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "callable"
    if isinstance(obj, dict):
        return ("mapping", tuple(sorted(obj)))
    return type(obj).__name__


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_has_a_counterpart(package):
    jax_mod = importlib.import_module(f"ray_tpu.{package}")
    port = importlib.import_module(f"ray_tpu_torch.{package}")
    exported = set(port.__all__)
    missing = [n for n in jax_mod.__all__
               if RENAMES.get(n, n) not in exported]
    assert not missing, f"ray_tpu_torch.{package} lacks {missing}"
    for name in jax_mod.__all__:
        ours = getattr(port, RENAMES.get(name, name))
        assert kind(ours) == kind(getattr(jax_mod, name)), name
    # Everything the port lists resolves.
    assert all(hasattr(port, n) for n in port.__all__)


def test_renames_are_real_renames():
    """Each rename maps a JAX-only name to a port-only one."""
    for package in PACKAGES:
        jax_mod = importlib.import_module(f"ray_tpu.{package}")
        port = importlib.import_module(f"ray_tpu_torch.{package}")
        for old, new in RENAMES.items():
            if old in jax_mod.__all__:
                assert new in port.__all__ and old not in port.__all__


def imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "serve_ab.py"]
    bad = []
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "ml_dtypes", "ray_tpu", "optax",
                       "flax", "orbax"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
