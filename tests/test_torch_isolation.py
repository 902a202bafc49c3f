"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and no entry point falls
back to the CPU on its own."""

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
