"""The port keeps the JAX package's API level: for every module of
``nfs_tpu``, every public top-level function and class, and every public
method of those classes, the counterpart module of ``nfs_tpu_torch``
(the same path; the Pallas kernel modules map onto the CUDA kernel
modules) has the name, and each of its parameters by name: a function's
or method's arguments, a class's ``__init__`` arguments or, for a
dataclass, its fields. A port method may come from a base class in the
port; a port function taking ``**kwargs`` accepts any keyword.

Both trees are read by AST; neither package is imported. Every
exception is in :data:`ALLOWED`, with its reason; an entry that no
longer matches a gap fails :func:`test_every_allowance_is_used`, so the
list cannot outlive what it excuses.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "nfs_tpu", REPO / "nfs_tpu_torch"
# the Pallas kernel modules' counterparts
RENAMED = {"ops/pallas_advect.py": "ops/advect_kernels.py",
           "ops/pallas_binsplat.py": "ops/binsplat_kernels.py"}

# {"module:Name", "module:Name.method", "module:Name(param)" or a bare
# parameter name, matching it everywhere: reason}
ALLOWED = {
    "key": "jax.random's key: the port draws from torch.Generators keyed "
           "on (seed, frame) or (seed, keyframe) and injects "
           "view_schedule to replay JAX's draws (ROADMAP queue 3, F4)",
    "axis_name": "JAX names a mesh axis inside shard_map; the port's "
                 "collectives take the Mesh and its axis's process group",
    "parallel/mesh.py:make_mesh(devices)":
        "a JAX device list; the port's mesh is the ranks of the "
        "torch.distributed world, one device per process",
    "parallel/spatial.py:replicate(mesh)":
        "a NamedSharding's mesh; the port copies the tree to a device",
    "parallel/sharding.py:make_sharded_window_step(loss_one_frame)":
        "the port's step takes loss_frames, a loss over the rank's batch "
        "of frames (one call, K1-K3 batched over frames), where JAX "
        "vmaps a per-frame loss",
    "parallel/sharding.py:make_sharded_window_step(opt_state_example)":
        "an optax state's structure for shard_map's specs; the port's "
        "Adam state needs none",
    "styler/octave.py:run_octave(params)":
        "named param in the port: one tensor or a dict of tensors",
    "utils/profiling.py:trace(create_perfetto_link)":
        "a jax.profiler option; the port writes a Chrome trace that "
        "Perfetto opens",
    "utils/profiling.py:enable_compile_cache":
        "XLA's persistent compilation cache: eager torch compiles "
        "nothing, and the CUDA kernels are cached on their sources' "
        "hash (ops/_cuda_build.py)",
    "ops/pallas_advect.py:pallas_window_advect":
        "the forward kernel's wrapper is advect_kernels.advect_fwd (K1)",
    "ops/pallas_advect.py:advect_pallas":
        "the differentiable kernel route is advect_kernels.AdvectWindow, "
        "which ops/advect.py's advect takes on a GPU",
    "ops/pallas_binsplat.py:splat_binned_pallas":
        "the kernel route is binsplat_kernels.splat_binned_window (K4, "
        "K5)",
    "ops/pallas_binsplat.py:shifted_layout":
        "the TPU's shifted-resident chunk layout, not carried to the GPU "
        "(ROADMAP: TPU-only workarounds)",
    "ops/pallas_binsplat.py:prep_shifted":
        "the shifted layout's packing, not carried (as shifted_layout)",
    "ops/pallas_binsplat.py:window_shifted":
        "the shifted layout's window pass, not carried (as "
        "shifted_layout)",
}

MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _class_params(cls):
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _params(node)
    return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)], False


def _defs(tree):
    """Public top-level functions and classes: {name: node}."""
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _port_classes():
    """Every class of the port by name, for the bases of a port class."""
    out = {}
    for path in PORT.rglob("*.py"):
        for n in ast.parse(path.read_text()).body:
            if isinstance(n, ast.ClassDef):
                out.setdefault(n.name, n)
    return out


CLASSES = _port_classes()


def _methods(cls):
    """A port class's methods, its bases' (classes of the port) too."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in CLASSES:
            out.update(_methods(CLASSES[base.id]))
    out.update({n.name: n for n in cls.body
                if isinstance(n, ast.FunctionDef)})
    return out


def gaps(module: str):
    """What the port lacks of one JAX module: "module:Name" (a function
    or class), "module:Name.method", or "module:Name(param)" /
    "module:Name.method(param)" with the parameter's name."""
    jax_defs = _defs(ast.parse((JAX / module).read_text()))
    port_defs = _defs(ast.parse(
        (PORT / RENAMED.get(module, module)).read_text()))
    out = []
    for name, node in jax_defs.items():
        twin = port_defs.get(name)
        if twin is None or type(twin) is not type(node):
            out.append((f"{module}:{name}", None))
            continue
        pairs = [(name, node, twin)]
        if isinstance(node, ast.ClassDef):
            methods = _methods(twin)
            for m in node.body:
                if (isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")):
                    if m.name not in methods:
                        out.append((f"{module}:{name}.{m.name}", None))
                    else:
                        pairs.append((f"{name}.{m.name}", m,
                                      methods[m.name]))
        for qual, want, have in pairs:
            get = _class_params if isinstance(want, ast.ClassDef) \
                else _params
            wanted, _ = get(want)
            got, any_keyword = get(have)
            out += [(f"{module}:{qual}({p})", p) for p in wanted
                    if p not in got and not any_keyword]
    return out


def _allowed(gap, param):
    return gap in ALLOWED or (param is not None and param in ALLOWED)


def test_the_walk_sees_every_module():
    assert {"styler/grid.py", "ops/shear.py", "ops/resize.py",
            "features/vgg.py", "parallel/multihost.py",
            "io/checkpoint.py"} <= set(MODULES)
    for module in MODULES:
        assert (PORT / RENAMED.get(module, module)).exists(), module


@pytest.mark.parametrize("module", MODULES)
def test_the_port_has_every_public_name_and_parameter(module):
    missing = [g for g, p in gaps(module) if not _allowed(g, p)]
    assert not missing, missing


def test_every_allowance_is_used():
    """Each entry of ALLOWED excuses at least one gap that exists today,
    and gives a reason."""
    used = set()
    for module in MODULES:
        for gap, param in gaps(module):
            used.add(gap if gap in ALLOWED else param)
    assert set(ALLOWED) == used, sorted(set(ALLOWED) - used)
    assert all(len(reason) > 20 for reason in ALLOWED.values())
