"""Every name an ``__init__`` of the JAX package exports resolves in the
port's package of the same name (``nfs_tpu.io`` -> ``nfs_tpu_torch.io``)
to the port's own counterpart, and is in that package's ``__all__``:
never a module, whatever was imported before, and for a function or a
class, the object of the same name in the port's module that matches
the JAX object's module. And a port package's ``__all__`` names nothing
more.

An ``__init__``'s exports are its ``__all__``, or, where it has none
(``nfs_tpu/__init__.py``), the names it imports from the package and the
names its lazy ``__getattr__`` serves."""

import ast
import importlib
import pkgutil
import types
from pathlib import Path

import pytest

import nfs_tpu

ROOT = Path(nfs_tpu.__file__).parent
# names of the JAX package's __init__s with no counterpart in the port
# (TPU-only or renamed), with the reason. None today: the TPU-only
# ``enable_compile_cache`` is exported by no __init__.
NOT_PORTED = {}


def _exports(init: Path):
    tree = ast.parse(init.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom)
             and (node.module or "").startswith("nfs_tpu")
             for a in node.names]
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "lazy":
            names += [ast.literal_eval(k) for k in node.value.keys]
    return names


INITS = sorted(ROOT.glob("**/__init__.py"))


def test_the_walk_sees_every_package():
    packages = {".".join(p.parent.relative_to(ROOT.parent).parts)
                for p in INITS}
    assert {"nfs_tpu", "nfs_tpu.io", "nfs_tpu.ops", "nfs_tpu.styler",
            "nfs_tpu.parallel"} <= packages
    assert {"StyleConfig", "config_replace", "GridStyler",
            "ParticleSet"} <= set(_exports(ROOT / "__init__.py"))


def _port_name(name: str) -> str:
    return name.replace("nfs_tpu", "nfs_tpu_torch", 1)


@pytest.mark.parametrize("init", INITS,
                         ids=lambda p: str(p.parent.relative_to(ROOT.parent)))
def test_every_export_resolves_in_the_port(init):
    package = ".".join(init.parent.relative_to(ROOT.parent).parts)
    port = importlib.import_module(_port_name(package))
    # import every submodule of the port's package first (and a styler,
    # which imports ops submodules): an export named as a submodule must
    # not turn into that submodule once it has been imported
    importlib.import_module("nfs_tpu_torch.styler.grid")
    for sub in pkgutil.iter_modules(port.__path__):
        importlib.import_module(f"{port.__name__}.{sub.name}")
    jax_package = importlib.import_module(package)
    for name in _exports(init):
        if name in NOT_PORTED:
            continue
        assert name in port.__all__, (package, name)
        obj = getattr(port, name)
        assert not isinstance(obj, types.ModuleType), (package, name)
        want = getattr(jax_package, name)
        if isinstance(want, (type, types.FunctionType)):
            home = importlib.import_module(_port_name(want.__module__))
            assert obj is getattr(home, want.__name__), (package, name)



@pytest.mark.parametrize("init", INITS,
                         ids=lambda p: str(p.parent.relative_to(ROOT.parent)))
def test_the_port_exports_nothing_more(init):
    """A port package's ``__all__`` names only what the JAX package's
    ``__init__`` of the same name exports: the port's other public names
    stay in their modules, as the JAX package keeps its own."""
    package = ".".join(init.parent.relative_to(ROOT.parent).parts)
    port = importlib.import_module(_port_name(package))
    extra = set(getattr(port, "__all__", ())) - set(_exports(init))
    assert not extra, (package, sorted(extra))
