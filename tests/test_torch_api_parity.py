"""The port's public surface against the reference's, read from source.

Both packages are parsed with :mod:`ast`, so nothing of JAX is imported. For
every module of ``src/repro/`` the module of the same path in
``src/repro_torch/`` must have each public top-level name (functions,
classes, assigned names), each public method of a class (``__init__``
included; inherited from a class of the same module counts), each argument
name of those functions and methods, each class-level attribute, each
``__all__`` entry and each ``add_argument`` flag. What the port does not
mirror on purpose is :data:`ALLOWED`, one rule a category, each with its
reason; a rule that allows nothing fails too, so the list cannot go stale.

The second test imports each port package and checks that ``from
repro_torch.<pkg> import *`` gives every name of the reference's
``__all__``. The third runs the checker on two tiny packages written to
``tmp_path`` and shows that it reports a missing function, method,
argument, ``__all__`` entry and flag.
"""
from __future__ import annotations

import ast
import importlib
from pathlib import Path
from typing import NamedTuple

import pytest

from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

PALLAS_TILING = {"interpret", "block_q", "block_k", "block_n", "block_d"}


class Gap(NamedTuple):
    """Something of the reference that the port's module of the same path
    lacks. ``kind`` is one of module, name, method, arg, all, flag; ``owner``
    the function (``Class.method`` for a method) an arg belongs to;
    ``port_args`` the argument names the port's function has."""

    kind: str
    module: str
    owner: str
    name: str
    port_args: tuple = ()


def _args(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _targets(node) -> list[str]:
    """The plain names an assignment binds (not attributes or subscripts)."""
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class Surface(NamedTuple):
    names: set
    funcs: dict  # name -> argument names
    classes: dict  # name -> {method or "attr:<name>": argument names}
    all: list
    flags: set


def surface(path: Path) -> Surface:
    """The public surface of one module's source."""
    tree = ast.parse(path.read_text())
    names, funcs, classes, all_, flags = set(), {}, {}, [], set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            funcs[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members = {}
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members[b.name] = _args(b)
                elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                    members.update({f"attr:{n}": [] for n in _targets(b)})
            for base in node.bases:  # inherited from a class of this module
                if isinstance(base, ast.Name) and base.id in classes:
                    for k, v in classes[base.id].items():
                        members.setdefault(k, v)
            classes[node.name] = members
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for n in _targets(node):
                names.add(n)
                if n == "__all__":
                    all_ = [e.value for e in node.value.elts]
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "add_argument":
            flags.update(a.value for a in n.args
                         if isinstance(a, ast.Constant) and str(a.value).startswith("-"))
    return Surface(names, funcs, classes, all_, flags)


def _public(name: str) -> bool:
    return not name.split(":")[-1].startswith("_") or name == "__init__"


def missing(ref_root: Path, port_root: Path) -> list[Gap]:
    """Every :class:`Gap` of ``port_root`` against ``ref_root``."""
    gaps = []
    for ref_path in sorted(ref_root.rglob("*.py")):
        rel = ref_path.relative_to(ref_root).as_posix()
        port_path = port_root / rel
        if not port_path.exists():
            gaps.append(Gap("module", rel, "", ""))
            continue
        ref, port = surface(ref_path), surface(port_path)
        gaps += [Gap("name", rel, "", n) for n in sorted(ref.names - port.names) if _public(n)]
        for fn, args in ref.funcs.items():
            if _public(fn) and fn in port.funcs:
                have = tuple(port.funcs[fn])
                gaps += [Gap("arg", rel, fn, a, have) for a in args if a not in have]
        for cls, members in ref.classes.items():
            if not _public(cls) or cls not in port.classes:
                continue
            for m, args in members.items():
                if not _public(m):
                    continue
                if m not in port.classes[cls]:
                    gaps.append(Gap("method", rel, cls, m))
                    continue
                have = tuple(port.classes[cls][m])
                gaps += [Gap("arg", rel, f"{cls}.{m}", a, have) for a in args if a not in have]
        gaps += [Gap("all", rel, "", n) for n in ref.all if n not in port.all]
        gaps += [Gap("flag", rel, "", f) for f in sorted(ref.flags - port.flags)]
    return gaps


class Rule(NamedTuple):
    why: str
    allows: object  # Gap -> bool


def _kernel_source(gap: Gap) -> bool:
    """A Pallas ``kernels/<name>/kernel.py`` whose kernels are the port's
    ``csrc/<name>.cu``."""
    parts = gap.module.split("/")
    return (gap.kind == "module" and len(parts) == 3 and parts[0] == "kernels"
            and parts[2] == "kernel.py" and (PORT / "csrc" / f"{parts[1]}.cu").exists())


#: What the port does not mirror on purpose: its idiom.
ALLOWED = [
    Rule("The Pallas kernel modules: each kernel is a CUDA source, csrc/<name>.cu, "
         "behind the wrapper in kernels/<name>/ops.py.", _kernel_source),
    Rule("Pallas tiling and interpret mode: the port's kernels choose their own tiles, and a "
         "CUDA kernel has no interpret mode (a CPU tensor takes the plain version).",
         lambda g: g.kind == "arg" and g.module.startswith("kernels/") and g.name in PALLAS_TILING),
    Rule("pairwise_distances_streamed's d_chunk capped the Pallas tile width; the CUDA kernel "
         "streams d in its own chunks (a host G takes pairwise_distances_chunked's d_chunk).",
         lambda g: (g.kind, g.module, g.owner, g.name)
         == ("arg", "kernels/similarity/ops.py", "pairwise_distances_streamed", "d_chunk")),
    Rule("A jax.random key becomes a torch.Generator, gen, or, where the port makes the "
         "generator itself (init_params), its int seed.",
         lambda g: (g.kind == "arg" and g.name == "key"
                    and ("gen" in g.port_args or "seed" in g.port_args))),
    Rule("xp switched the sketch hash between numpy and jax.numpy; the port's hash runs on torch "
         "tensors (the numpy references take its blocks).",
         lambda g: g.kind == "arg" and g.module == "kernels/sketch/ref.py" and g.name == "xp"),
    Rule("backend chose numpy or jax for the store and the tracker; the port takes a device, and "
         "its CPU path is bit-equal to the numpy backend.",
         lambda g: (g.kind == "arg" and g.name == "backend" and "device" in g.port_args
                    and g.owner in ("GradientStore.__init__", "AvailabilityTracker.__init__"))),
    Rule("*_shape pytrees of jax.ShapeDtypeStruct become the port's tensors (meta ones where only "
         "shapes matter) or its LM.",
         lambda g: (g.kind == "arg" and g.name.endswith("_shape")
                    and (g.module == "launch/sharding.py"
                         or (g.module, g.owner) == ("launch/roofline.py", "active_params")))),
    Rule("XLA-only: normalize_cost_analysis reads XLA's cost analysis and parse_collectives its "
         "HLO text; the port's CostCounter counts its own ops directly.",
         lambda g: (g.kind, g.module, g.name) in {("name", "launch/dryrun.py", "normalize_cost_analysis"),
                                                  ("name", "launch/roofline.py", "parse_collectives")}),
]


def _unallowed(gaps: list[Gap]) -> list[Gap]:
    return [g for g in gaps if not any(rule.allows(g) for rule in ALLOWED)]


def test_port_covers_the_reference_public_surface():
    gaps = missing(REF, PORT)
    assert _unallowed(gaps) == []
    stale = [rule.why for rule in ALLOWED if not any(rule.allows(g) for g in gaps)]
    assert stale == [], "allow-list rules that allow nothing"


def _packages_with_all() -> list[str]:
    return sorted(p.parent.relative_to(REF).as_posix() for p in REF.rglob("__init__.py")
                  if surface(p).all)


@pytest.mark.parametrize("pkg", _packages_with_all())
def test_star_import_gives_every_name_of_the_reference_all(pkg):
    """``from repro_torch.<pkg> import *`` binds every name of the
    reference's ``__all__``, and importing the package builds no kernel."""
    from repro_torch.kernels import _build

    want = surface(REF / pkg / "__init__.py").all
    module = importlib.import_module("repro_torch." + pkg.replace("/", "."))
    namespace = {}
    exec(f"from {module.__name__} import *", namespace)
    assert [n for n in want if n not in namespace] == []
    assert _build._loaded == {}


REF_MOD = '''
import argparse

__all__ = ["f", "C", "g"]


def f(x, *, scale=1.0):
    return x


def g():
    pass


class C:
    def __init__(self, n, *, seed=0):
        self.n = n

    def step(self, t):
        return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--seed", type=int)
'''

PORT_MOD = REF_MOD.replace("import argparse", "import argparse  # the port")


@pytest.mark.parametrize("drop,want", [
    (None, []),
    ("function", [Gap("name", "pkg/mod.py", "", "g")]),
    ("method", [Gap("method", "pkg/mod.py", "C", "step")]),
    ("argument", [Gap("arg", "pkg/mod.py", "f", "scale", ("x",))]),
    ("init_argument", [Gap("arg", "pkg/mod.py", "C.__init__", "seed", ("self", "n"))]),
    ("all", [Gap("all", "pkg/mod.py", "", "C")]),
    ("flag", [Gap("flag", "pkg/mod.py", "", "--seed")]),
    ("module", [Gap("module", "pkg/mod.py", "", "")]),
])
def test_checker_reports_what_the_port_lacks(tmp_path, drop, want):
    """Two tiny packages, the port's with one thing taken out: the checker
    reports exactly it, and the allow-list does not hide it."""
    port = PORT_MOD
    edits = {
        "function": ("def g():\n    pass\n", ""),
        "method": ("    def step(self, t):\n        return t\n", ""),
        "argument": ("def f(x, *, scale=1.0):", "def f(x):"),
        "init_argument": ("def __init__(self, n, *, seed=0):", "def __init__(self, n):"),
        "all": ('__all__ = ["f", "C", "g"]', '__all__ = ["f", "g"]'),
        "flag": ('    ap.add_argument("--seed", type=int)\n', ""),
    }
    if drop in edits:
        old, new = edits[drop]
        assert old in port
        port = port.replace(old, new)
    for root, text in ((tmp_path / "ref", REF_MOD), (tmp_path / "port", port)):
        (root / "pkg").mkdir(parents=True)
        (root / "pkg" / "__init__.py").write_text("")
        if not (drop == "module" and root.name == "port"):
            (root / "pkg" / "mod.py").write_text(text)
    gaps = missing(tmp_path / "ref", tmp_path / "port")
    assert gaps == want
    assert _unallowed(gaps) == want
