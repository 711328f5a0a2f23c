"""The port's public surface held to the JAX package's.

Every module of ``tadataka_tpu/`` is read with ``ast`` (nothing is
imported, so nothing compiles) beside its counterpart in
``tadataka_torch/``: each public function, class, method, class field
and module constant, each name an ``__init__`` exports, and each
parameter name of a function or method must be there in the port, but
for the ground rules' exclusions below (ROADMAP.md, "Parity wins over TPU
tricks"), each with its reason.  A name the port imports or assigns from
elsewhere counts; a method may come from a base class.  The port may add
parameters (``device``, ``rng``) and names of its own.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "tadataka_tpu"
PORT_ROOT = ROOT / "tadataka_torch"

TENT = ("a TPU tent / shift-sum form; the port keeps only its plain "
        "gather reference (ROADMAP.md ground rules)")
BUDGET = ("a static displacement budget of the TPU tent warps; the "
          "port's gathers have no budget")
SHARDING = ("a JAX sharding spec (a NamedSharding, a shard_map axis "
            "name); the port's mesh.shard / replicate place a tensor's "
            "blocks and psum sums over the mesh, with no spec or axis")
EXCLUDED_MODULES = {
    "utils/padding.py": "pow2 capacity buckets for jit; eager PyTorch "
                        "compiles nothing per shape, so the port works at "
                        "the true counts (ROADMAP.md ground rules)",
}
EXCLUDED_NAMES = {
    ("core/shiftwarp.py", "shift_warp_cols"): TENT,
    ("core/shiftwarp.py", "shift_warp_cols_block"): TENT,
    ("core/shiftwarp.py", "shift_warp_rows"): TENT,
    ("core/shiftwarp.py", "shift_warp_multi"): TENT,
    ("core/shiftwarp.py", "rot_warp_batch"): TENT,
    ("core/shiftwarp.py", "rot_warp_cols_block"): TENT,
    ("core/shiftwarp.py", "tent_sample"): TENT + ": interpolate",
    ("vo/semi_dense/propagation.py", "propagate_tent"):
        TENT + ": propagate + increment_age",
    ("vo/semi_dense/__init__.py", "propagate_tent"):
        TENT + ": propagate + increment_age",
    ("vo/semi_dense/sweep.py", "warp_plane_stack_tent"):
        TENT + ": warp_plane_stack",
    ("vo/semi_dense/fast.py", "plan_flow_bounds"):
        "plans only propagate_tent's tap bounds",
    ("vo/semi_dense/fast.py", "FLOW_TAPS_MAX"):
        "propagate_tent's tap budget",
    ("vo/semi_dense/fast.py", "KEY_BUDGET"): BUDGET,
    ("vo/semi_dense/sweep_rect.py", "DEFAULT_MAX_DX"): BUDGET,
    ("vo/semi_dense/sweep_rect.py", "DEFAULT_MAX_DY"): BUDGET,
    ("parallel/mesh.py", "row_sharding"): SHARDING,
    ("parallel/mesh.py", "replicated"): SHARDING,
    ("parallel/distributed_ba.py", "AXIS"): SHARDING,
}
# parameters dropped everywhere, with the reason
EXCLUDED_PARAMS = {
    "use_pallas": "the Pallas / XLA switch; the port's wrapper launches "
                  "its CUDA kernel on a card tensor, the plain version on "
                  "a CPU one",
    "sample_budget": "DVO's TPU sample budget; the port samples every "
                     "pixel",
    "dvo_sample_budget": "DVO's TPU sample budget; the port samples every "
                         "pixel",
    "max_dx": BUDGET,
    "max_dy": BUDGET,
    "warp_budget": BUDGET,
    "key_budget": BUDGET,
}
# JAX PRNG keys, dropped where the port's function takes ``rng`` instead
PRNG_PARAMS = ("key", "keys")


def _parse(path):
    return ast.parse(path.read_text(), filename=str(path))


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{x.arg}" for x in (a.vararg,) if x is not None]
    names += [f"**{x.arg}" for x in (a.kwarg,) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _top_level(tree):
    """The module's statements, with those of its top-level ``if`` and
    ``try`` blocks."""
    for node in tree.body:
        yield node
        if isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse,
                          getattr(node, "finalbody", [])):
                yield from block


def _public(name):
    return not name.startswith("_")


def _method(name):
    return _public(name) or name in ("__init__", "__call__")


def jax_surface(path):
    """{name: ("def", params) | ("class", None) | ("field", None) |
    ("const", None) | ("export", None)}; methods and fields as
    "Class.name"."""
    out = {}
    init = path.name == "__init__.py"
    for node in _parse(path).body:
        if isinstance(node, ast.FunctionDef) and _public(node.name):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = ("class", None)
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and _method(sub.name):
                    out[f"{node.name}.{sub.name}"] = ("def", _params(sub))
                elif (isinstance(sub, ast.AnnAssign)
                      and isinstance(sub.target, ast.Name)
                      and _public(sub.target.id)):
                    out[f"{node.name}.{sub.target.id}"] = ("field", None)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and _public(t.id):
                    out[t.id] = ("const", None)
        elif isinstance(node, ast.ImportFrom) and init:
            for alias in node.names:
                name = alias.asname or alias.name
                if _public(name):
                    out[name] = ("export", None)
    return out


class Port:
    """Resolves a name of a port module to what defines it, following
    imports and plain aliases (``X = Y``) within the port."""

    def __init__(self):
        self._trees = {}

    def tree(self, module):
        """``module``: a path relative to the package root."""
        if module not in self._trees:
            path = PORT_ROOT / module
            self._trees[module] = _parse(path) if path.exists() else None
        return self._trees[module]

    @staticmethod
    def _module_of(dotted, level, here):
        """The package-relative path of an imported port module, or None
        for a module outside the port."""
        if level:
            base = Path(here).parent
            for _ in range(level - 1):
                base = base.parent
            parts = list(base.parts) + (dotted.split(".") if dotted else [])
        else:
            parts = dotted.split(".")
            if parts[0] != "tadataka_torch":
                return None
            parts = parts[1:]
        rel = Path(*parts) if parts else Path()
        if (PORT_ROOT / rel).is_dir():
            return str(rel / "__init__.py")
        return str(rel) + ".py"

    def lookup(self, module, name, depth=0):
        """The defining node of ``name`` in ``module`` (FunctionDef,
        ClassDef, or another node for a constant or an outside import),
        or None if the module does not bind it."""
        tree = self.tree(module)
        if tree is None or depth > 8:
            return None
        found = None
        for node in _top_level(tree):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    and node.name == name:
                return node
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if (alias.asname or alias.name) != name:
                        continue
                    source = self._module_of(node.module or "", node.level,
                                             module)
                    if source is None:
                        return node
                    package = PORT_ROOT / Path(source).parent
                    if (package / (alias.name + ".py")).exists() or (
                            package / alias.name).is_dir():
                        return node      # a submodule
                    return self.lookup(source, alias.name, depth + 1) or node
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if (alias.asname or alias.name.split(".")[0]) == name:
                        return node
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [e.id for t in targets
                         for e in (t.elts if isinstance(t, ast.Tuple)
                                   else [t]) if isinstance(e, ast.Name)]
                if name in names:
                    value = node.value
                    if isinstance(value, ast.Name) and value.id != name:
                        found = (self.lookup(module, value.id, depth + 1)
                                 or node)
                    else:
                        found = node
        return found

    def member(self, module, cls, name, depth=0):
        """A method or field ``name`` of class ``cls`` (a ClassDef of
        ``module``), looked up through its bases in the port."""
        for sub in cls.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == name:
                return sub
            if (isinstance(sub, ast.AnnAssign)
                    and isinstance(sub.target, ast.Name)
                    and sub.target.id == name):
                return sub
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in sub.targets):
                return sub
        if depth > 8:
            return None
        for base in cls.bases:
            if isinstance(base, ast.Name):
                node = self.lookup(module, base.id)
                if isinstance(node, ast.ClassDef):
                    found = self.member(self.home(module, base.id), node,
                                        name, depth + 1)
                    if found is not None:
                        return found
        return None

    def home(self, module, name, depth=0):
        """The module that defines ``name`` as seen from ``module``."""
        tree = self.tree(module)
        if tree is None or depth > 8:
            return module
        for node in _top_level(tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if (alias.asname or alias.name) == name:
                        source = self._module_of(node.module or "",
                                                 node.level, module)
                        if source is not None:
                            return self.home(source, alias.name, depth + 1)
        return module


PORT = Port()
JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT))
                     for p in JAX_ROOT.rglob("*.py"))


def _port_class(module, name):
    node = PORT.lookup(module, name)
    if isinstance(node, ast.ClassDef):
        return PORT.home(module, name), node
    return None, None


def surface_gaps(module):
    """What the JAX module has and its port counterpart lacks, but for
    the exclusions: a list of strings."""
    gaps = []
    for name, (kind, params) in jax_surface(JAX_ROOT / module).items():
        top, _, member = name.partition(".")
        if (module, top) in EXCLUDED_NAMES:
            continue
        if not member:
            node = PORT.lookup(module, name)
            if node is None:
                gaps.append(f"{kind} {name}")
                continue
            if kind == "class" and not isinstance(
                    node, (ast.ClassDef, ast.ImportFrom, ast.Assign)):
                gaps.append(f"{name} is not a class")
                continue
        else:
            home, cls = _port_class(module, top)
            if cls is None:
                continue            # the class itself is reported
            node = PORT.member(home, cls, member)
            if node is None:
                gaps.append(f"{kind} {name}")
                continue
        if kind == "def":
            if not isinstance(node, ast.FunctionDef):
                gaps.append(f"{name} is not a function in the port")
                continue
            port_params = _params(node)
            for p in params:
                if p in port_params or p in EXCLUDED_PARAMS:
                    continue
                if p in PRNG_PARAMS and "rng" in port_params:
                    continue
                gaps.append(f"{name}: parameter {p}")
    return gaps


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_surface(module):
    if module in EXCLUDED_MODULES:
        assert not (PORT_ROOT / module).exists(), (
            f"{module} is excluded ({EXCLUDED_MODULES[module]}) but ported:"
            " drop the exclusion")
        return
    assert (PORT_ROOT / module).exists(), f"no tadataka_torch/{module}"
    gaps = surface_gaps(module)
    assert not gaps, f"tadataka_torch/{module} lacks: {gaps}"


def test_exclusions_name_real_gaps():
    """Each excluded name is in the JAX module and not in the port, so
    the table cannot outlive what it excuses."""
    for (module, name), reason in EXCLUDED_NAMES.items():
        assert reason
        assert name in jax_surface(JAX_ROOT / module), (module, name)
        assert PORT.lookup(module, name) is None, (module, name)
    jax_params = set()
    for module in JAX_MODULES:
        if module in EXCLUDED_MODULES:
            continue
        for kind, params in jax_surface(JAX_ROOT / module).values():
            jax_params.update(params or ())
    assert set(EXCLUDED_PARAMS) <= jax_params, (
        set(EXCLUDED_PARAMS) - jax_params)
    assert set(PRNG_PARAMS) <= jax_params


PORT_MODULES = sorted(str(p.relative_to(ROOT))
                      for p in PORT_ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", PORT_MODULES)
def test_port_module_imports_no_jax(path):
    """No module of the port, its examples included, imports ``jax`` or
    the JAX package."""
    for node in ast.walk(_parse(ROOT / path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "tadataka_tpu"), (path, name)


def test_surface_check_sees_a_gap():
    """The check reports a missing method, a missing parameter and a
    missing export when the port lacks them (a synthetic port module)."""
    port = Port()
    module = "camera/parameters.py"
    tree = ast.parse((PORT_ROOT / module).read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef))
    cls.body = [n for n in cls.body
                if not (isinstance(n, ast.FunctionDef)
                        and n.name == "matrix")]
    create = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
                  and n.name == "create")
    create.args.args = [a for a in create.args.args if a.arg != "offset"]
    create.args.defaults = create.args.defaults[-len(create.args.args):]
    port._trees[module] = tree
    global PORT
    saved, PORT = PORT, port
    try:
        gaps = surface_gaps(module)
    finally:
        PORT = saved
    assert "def CameraParameters.matrix" in gaps, gaps
    assert "CameraParameters.create: parameter offset" in gaps, gaps
