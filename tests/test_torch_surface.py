"""Nothing of the reference package is left without a counterpart in the
port: a check of the two packages' sources with ``ast`` (no import, so no
JAX).

For every module of ``coda_tpu/`` (``MODULE_MAP`` renames the two Pallas
modules, ``demo/app.py`` maps to ``coda_tpu_torch/demo/app.py``):

* the module has a counterpart file in ``coda_tpu_torch/``;
* every public top-level name it defines, and every name in its
  ``__all__``, is bound at the top level of the counterpart (defined,
  assigned or imported), under its own name or the one ``NAME_MAP``
  gives it;
* every command-line flag it parses is parsed by its counterpart (or, for
  the CLI, by the port's ``suite`` verb), ``--platform`` being the port's
  ``--device``;

and the CLI's verbs, the demo's routes, its ``DemoSession`` methods and
arguments and the JSON fields of its page state are the port's too. The
only exceptions are ``JAX_ONLY``, each with its reason; an entry that
names something the reference no longer has, or that the port does
have, fails as stale.
"""

from __future__ import annotations

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "coda_tpu")
PORT = os.path.join(ROOT, "coda_tpu_torch")

# reference module (relative to coda_tpu/, or the repo for the demo) ->
# the port's (relative to coda_tpu_torch/)
MODULE_MAP = {
    "ops/pallas_eig.py": "ops/eig_kernels.py",
    "ops/pallas_gather.py": "ops/gather_kernels.py",
}
DEMO_REF, DEMO_PORT = "demo/app.py", "demo/app.py"

# (reference module, name) -> the port's name for it
NAME_MAP = {
    ("ops/pallas_eig.py", "eig_scores_cache_pallas"): "eig_scores_cache",
    ("ops/pallas_eig.py", "eig_scores_refresh_pallas"): "eig_scores_refresh",
    ("ops/pallas_eig.py", "eig_scores_refresh_compute_pallas"):
        "eig_scores_refresh_compute",
    ("ops/pallas_eig.py", "eig_scores_cache_pallas_batched"):
        "eig_scores_cache_batched",
    ("ops/pallas_eig.py", "eig_scores_refresh_pallas_batched"):
        "eig_scores_refresh_batched",
    ("ops/pallas_eig.py", "eig_scores_cache_pallas_sharded"):
        "eig_scores_cache_sharded",
    ("ops/pallas_eig.py", "eig_scores_refresh_pallas_sharded"):
        "eig_scores_refresh_sharded",
    ("ops/pallas_gather.py", "gather_rows_sum_prepped"): "gather_rows_sum",
    ("ops/pallas_gather.py", "gather_rows_sum_xla"): "gather_rows_sum_plain",
}
FLAG_MAP = {"--platform": "--device"}
# the reference's single-task parser takes the suite's flags only to
# refuse them; the port's suite verb parses them
FLAG_FILES = {"cli.py": ("cli.py", "run_suite.py")}

_COSTS = ("XLA's cost analysis of a compiled executable; the port's cost "
          "book is analytic (telemetry/costs.kernel_work)")
_HOOKS = ("subscribes to jax.monitoring's compile events; the port counts "
          "its nvcc builds and loads (telemetry/registry.install_build_"
          "hooks)")
_SHARDING = ("a jax.sharding placement; the port places a rank's block "
             "itself (parallel/mesh.shard_preds)")
JAX_ONLY = {
    ("ops/pallas_eig.py", "choose_block"):
        "the N tile under the TPU's VMEM budget; the CUDA kernels size "
        "their blocks from the card (ops/eig_kernels.choose_class_chunks, "
        "row_plan)",
    ("ops/pallas_eig.py", "batched_pallas_viable"):
        "the padded-VMEM test of the custom_vmap fallback; the port's "
        "batched kernels 4 and 5 take any replica count",
    ("telemetry/costs.py", "analyze_compiled"): _COSTS,
    ("telemetry/costs.py", "harvest_executable_cost"): _COSTS,
    ("telemetry/costs.py", "PEAK_FLOPS"):
        "TPU peaks; the port's peak table is telemetry/costs.card_peaks",
    ("telemetry/costs.py", "PEAK_HBM_BPS"):
        "TPU peaks; the port's peak table is telemetry/costs.card_peaks",
    ("telemetry/__init__.py", "analyze_compiled"): _COSTS,
    ("telemetry/__init__.py", "harvest_executable_cost"): _COSTS,
    ("telemetry/registry.py", "install_jax_hooks"): _HOOKS,
    ("telemetry/registry.py", "jax_hooks_installed"): _HOOKS,
    ("telemetry/__init__.py", "install_jax_hooks"): _HOOKS,
    ("telemetry/__init__.py", "jax_hooks_installed"): _HOOKS,
    ("parallel/mesh.py", "preds_sharding"): _SHARDING,
    ("parallel/__init__.py", "preds_sharding"): _SHARDING,
    ("parallel/mesh.py", "shard_map_compat"):
        "jax.shard_map across jax versions; the port's collectives are "
        "torch.distributed calls (parallel/collectives.py)",
    ("utils/platform.py", "pin_platform"):
        "pins a JAX platform; the port's entry points take device= "
        "(utils/platform.resolve_device)",
    ("utils/platform.py", "enable_compilation_cache"):
        "JAX's persistent compilation cache; the port's kernels build "
        "into ops/build.BUILD_DIR (--compilation-cache-dir sets it)",
    ("utils/checks.py", "jit_check_finite"):
        "a host callback from inside jit; the port runs eagerly and "
        "checks with check_finite",
    ("ops/confusion.py", "PREDS_ONESHOT_MAX_BYTES"):
        "a TPU compile-time bound on one-shot contractions "
        "(coda_tpu/ops/confusion.py:28-62)",
    ("ops/confusion.py", "oneshot_precision"):
        "lowers the matmul precision past that TPU compile bound; the "
        "port's contractions stay fp32",
    ("selectors/coda.py", "resolve_eig_backend"):
        "routes scoring on jax.default_backend(), a TPU decision that "
        "does not carry over; the port's backend names the kernels "
        "(auto) or their plain versions",
}

_VERB = re.compile(r"^[a-z][a-z-]*$")


def _ref_modules() -> list[str]:
    out = []
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF)
                           .replace(os.sep, "/"))
    return sorted(out)


def _port_path(rel: str) -> str:
    return os.path.join(PORT, MODULE_MAP.get(rel, rel))


def _tree(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), path)


def _targets(node) -> set:
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, (ast.Tuple, ast.List)):
        return set().union(*(_targets(e) for e in node.elts))
    return set()


def _all(tree: ast.Module) -> set:
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any("__all__" in _targets(t) for t in targets) and \
                    node.value is not None:
                names |= {e.value for e in ast.walk(node.value)
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)}
    return names


def public_names(tree: ast.Module) -> set:
    """The names a reference module offers: its public top-level
    definitions and assignments, and its ``__all__``."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                names |= _targets(t)
        elif isinstance(node, ast.AnnAssign):
            names |= _targets(node.target)
    return {n for n in names if not n.startswith("_")} | _all(tree)


def bound_names(tree: ast.Module) -> set:
    """Every name bound at a module's top level (also inside top-level
    ``if``/``try`` blocks): definitions, assignments and imports."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    names.update(_targets(t))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                names.update(_targets(node.target))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    names.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
                visit(node.finalbody)

    visit(tree.body)
    return names


def flags(tree: ast.Module) -> set:
    """The option strings of every ``add_argument`` call."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")}
    return out


def cli_verbs(tree: ast.Module) -> set:
    """The verbs ``main`` dispatches on (``argv[0] == "serve"`` or ``in
    ("serve", ...)``)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Subscript) and \
                getattr(node.left.value, "id", None) == "argv":
            for c in node.comparators:
                out |= {e.value for e in ast.walk(c)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                        and _VERB.match(e.value)}
    return out


def _class(tree: ast.Module, name: str) -> ast.ClassDef:
    return next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == name)


def missing_names(rel: str, ref_path: str, port_path: str) -> list:
    have = bound_names(_tree(port_path))
    return sorted(n for n in public_names(_tree(ref_path))
                  if (rel, n) not in JAX_ONLY
                  and NAME_MAP.get((rel, n), n) not in have)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", _ref_modules())
def test_port_module_and_names_have_counterparts(rel):
    port = _port_path(rel)
    assert os.path.exists(port), f"coda_tpu/{rel} has no counterpart"
    missing = missing_names(rel, os.path.join(REF, rel), port)
    assert not missing, (f"coda_tpu/{rel}: no counterpart in "
                         f"{os.path.relpath(port, ROOT)} for {missing}")


def _flag_modules() -> list[str]:
    return [r for r in _ref_modules() if flags(_tree(os.path.join(REF, r)))]


@pytest.mark.parametrize("rel", _flag_modules())
def test_port_cli_flags_have_counterparts(rel):
    have = set().union(*(flags(_tree(os.path.join(PORT, f)))
                         for f in FLAG_FILES.get(rel, (rel,))))
    missing = sorted(f for f in flags(_tree(os.path.join(REF, rel)))
                     if FLAG_MAP.get(f, f) not in have)
    assert not missing, f"coda_tpu/{rel}: the port parses no {missing}"


def test_port_cli_verbs():
    ref = cli_verbs(_tree(os.path.join(REF, "cli.py")))
    port = cli_verbs(_tree(os.path.join(PORT, "cli.py")))
    assert {"serve", "replay", "replay-serve", "suite", "quality",
            "trace"} <= ref
    assert ref <= port, f"verbs the port lacks: {sorted(ref - port)}"


def test_port_jax_only_list_is_current():
    """Every JAX-only entry names something the reference has and the
    port does not, with a reason."""
    for (rel, name), why in JAX_ONLY.items():
        assert why, (rel, name)
        assert name in public_names(_tree(os.path.join(REF, rel))), \
            f"stale: coda_tpu/{rel} has no {name}"
        assert name not in bound_names(_tree(_port_path(rel))), \
            f"stale: the port has {name} in {MODULE_MAP.get(rel, rel)}"
    for (rel, name), to in NAME_MAP.items():
        assert name in public_names(_tree(os.path.join(REF, rel)))
        assert to in bound_names(_tree(_port_path(rel))), (rel, to)


def _demo_trees():
    return (_tree(os.path.join(ROOT, DEMO_REF)),
            _tree(os.path.join(PORT, DEMO_PORT)))


def test_port_demo_module_names_and_flags():
    ref, port = _demo_trees()
    missing = sorted(public_names(ref) - bound_names(port))
    assert not missing, f"the port's demo lacks {missing}"
    for name in ("DemoSession", "Handler", "make_server",
                 "resolve_image_paths", "default_factory", "main"):
        assert name in public_names(ref)
    lost = sorted(f for f in flags(ref) if FLAG_MAP.get(f, f) not in
                  flags(port))
    assert not lost, f"the port's demo parses no {lost}"


def _routes(cls: ast.ClassDef) -> set:
    return {e.value for e in ast.walk(cls)
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
            and re.match(r"^/(api/[a-z]+|index\.html)?$", e.value)}


def test_port_demo_routes():
    ref, port = _demo_trees()
    want = _routes(_class(ref, "Handler"))
    assert {"/", "/api/start", "/api/answer", "/api/state",
            "/api/image"} <= want
    got = _routes(_class(port, "Handler"))
    assert want <= got, f"routes the port lacks: {sorted(want - got)}"


def _methods(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_port_demo_session_methods_and_arguments():
    ref, port = _demo_trees()
    want = _methods(_class(ref, "DemoSession"))
    got = _methods(_class(port, "DemoSession"))
    assert {"__init__", "next_item", "answer", "state"} <= set(want)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for name, fn in want.items():
        args = [a.arg for a in fn.args.args]
        have = [a.arg for a in got[name].args.args]
        assert have[:len(args)] == args, (name, args, have)


def _state_keys(cls: ast.ClassDef) -> set:
    fn = _methods(cls)["state"]
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
    return keys


def test_port_demo_state_fields():
    ref, port = _demo_trees()
    want = _state_keys(_class(ref, "DemoSession"))
    assert {"idx", "pbest", "true_label", "n_labeled"} <= want
    assert _state_keys(_class(port, "DemoSession")) == want
