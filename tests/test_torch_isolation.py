"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and no entry point falls
back to the CPU on its own."""

import ast
import importlib
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")

#: an import of jax or of the JAX package (``repro`` / ``repro.x``)
BANNED = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s)"
    r"|import\s+.*\b(jax|repro)\b(?!_))", re.M)


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_or_repro_imports_in_the_port():
    found = list(_sources())
    assert any(p.endswith("chip_smoke.py") and os.path.exists(p)
               for p in found)
    assert any(p.endswith(os.path.join("models", "ssm.py")) for p in found)
    for path in found:
        with open(path) as f:
            text = f.read()
        hits = [m.group(0).strip() for m in BANNED.finditer(text)]
        assert not hits, (path, hits)
        assert "__import__(" not in text and "import_module(" not in text, \
            path


def test_banned_pattern_catches_the_forms_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from repro.core import phases", "import repro",
                "import os, jax", "from repro import apps"):
        assert BANNED.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import phases",
               "import torch"):
        assert not BANNED.search(ok), ok


def test_import_and_cpu_run_leave_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "from repro_torch.core import run_schedule, taskgraph, SimConfig\n"
        "import repro_torch.apps, repro_torch.kernels.sched_queue\n"
        "import repro_torch.kernels.sched_step\n"
        "from repro_torch.core import CaseSpec, run_cases\n"
        "r = run_schedule(taskgraph.fib(6), cfg=SimConfig(n_workers=4, "
        "n_zones=2), device='cpu')\n"
        "assert r.completed, r\n"
        "s = run_cases(taskgraph.fib(5), [CaseSpec(n_workers=4)], "
        "strategy='batched', backend='cuda_fused', device='cpu')\n"
        "assert s.completed.all(), s\n"
        "from repro_torch.core import tune_spec\n"
        "t = tune_spec(taskgraph.fib(5), 'na_ws', SimConfig(n_workers=4, "
        "n_zones=2), rounds=0, coarse=dict(n_victim=(1,), n_steal=(1,), "
        "t_interval=(10,), p_local=(1.0,)), device='cpu')\n"
        "assert t['n_sims'] == 1, t\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.models.rwkv, repro_torch.kernels.rwkv6_scan\n"
        "import repro_torch.kernels.registry, repro_torch.core.prng\n"
        "import repro_torch.core.balance, repro_torch.models.moe\n"
        "import repro_torch.kernels.moe_dispatch\n"
        "from repro_torch.launch import serve\n"
        "g = serve.main(['--smoke', '--batch', '1', '--prompt-len', '8', "
        "'--gen', '2', '--device', 'cpu'])\n"
        "assert tuple(g.ids.shape) == (1, 2), g.ids\n"
        "g = serve.main(['--arch', 'moonshot_v1_16b_a3b', '--smoke', "
        "'--batch', '1', '--prompt-len', '8', '--gen', '2', '--device', "
        "'cpu'])\n"
        "assert tuple(g.ids.shape) == (1, 2), g.ids\n"
        "import repro_torch.models.ssm\n"
        "g = serve.main(['--arch', 'hymba_1_5b', '--smoke', '--batch', '1', "
        "'--prompt-len', '8', '--gen', '2', '--device', 'cpu'])\n"
        "assert tuple(g.ids.shape) == (1, 2), g.ids\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', r.time_ns)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("ok"), proc.stdout


def test_no_device_means_an_error_not_a_cpu_run():
    from repro_torch.core import run_schedule, taskgraph
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_schedule(taskgraph.fib(4))


#: the JAX package's public core names that have no same-named port, by
#: design, each with its counterpart
NOT_PORTED = {
    # the port picks a step backend from the device, with no environment
    # switch: backends.BACKENDS, resolve_name, step_ops and run_loop
    ("backends", "ENV_VAR"): "backends.resolve_name (no environment switch)",
    ("backends", "StepBackend"): "backends.step_ops and backends.run_loop",
    ("backends", "ReferenceBackend"): "backends.BACKENDS['reference']",
    ("backends", "PallasBackend"): "backends.BACKENDS['cuda']",
    ("backends", "PallasFusedBackend"): "backends.BACKENDS['cuda_fused']",
    ("backends", "get_backend"): "backends.resolve_name / step_ops",
    # a JAX indirection for the traced where
    ("costs", "jnp_where"): "torch.where",
    # the package re-exports two of the names above
    ("__init__", "StepBackend"): "backends.step_ops and backends.run_loop",
    ("__init__", "get_backend"): "backends.resolve_name / step_ops",
}


def _public_names(path):
    """Functions and classes defined in a module, upper-case constants
    assigned there and its ``__all__`` entries, without a leading ``_``
    (names it imports do not count)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for n in ast.walk(target):
                    if not isinstance(n, ast.Name):
                        continue
                    if n.id == "__all__":
                        names.update(ast.literal_eval(node.value))
                    elif n.id.isupper():
                        names.add(n.id)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_repro_core_has_a_port():
    """``repro_torch.core`` does everything ``repro.core`` does: each
    public name of each of its modules has a same-named counterpart, but
    for the mapped ones of ``NOT_PORTED``.  The JAX sources are parsed,
    not imported."""
    core = os.path.join(ROOT, "src", "repro", "core")
    modules = sorted(f[:-3] for f in os.listdir(core) if f.endswith(".py"))
    assert "tune" in modules and "__init__" in modules
    missing, seen = [], set()
    for mod in modules:
        names = _public_names(os.path.join(core, mod + ".py"))
        port = importlib.import_module(
            "repro_torch.core" + ("" if mod == "__init__" else "." + mod))
        for name in sorted(names):
            if (mod, name) in NOT_PORTED:
                seen.add((mod, name))
                assert not hasattr(port, name), (mod, name, "now ported")
            elif not hasattr(port, name):
                missing.append(f"{mod}.{name}")
    assert not missing, missing
    assert seen == set(NOT_PORTED), set(NOT_PORTED) - seen


def test_public_names_are_what_the_rule_says():
    names = _public_names(os.path.join(ROOT, "src", "repro", "core",
                                       "messaging.py"))
    assert {"ROUND_BITS", "pack", "unpack", "Cells", "thief_send"} <= names
    assert not {"jax", "jnp", "NamedTuple", "Tuple"} & names
    assert "tune_spec" in _public_names(
        os.path.join(ROOT, "src", "repro", "core", "__init__.py"))
