"""The port stands alone: no JAX, nothing of the JAX package, no optax.

``raft_tpu_torch`` (every module of it) and ``chip_smoke.py`` are
imported in a fresh interpreter, which must then hold no ``jax*`` module,
no ``optax`` module (it imports JAX; the port writes its optimizers
itself) and no ``raft_tpu`` / ``raft_tpu.*`` module (the pattern does not
match ``raft_tpu_torch``); and their sources must not import any.
"""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^(jax|jaxlib|optax|raft_tpu)(\.|$)")
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|optax|raft_tpu)(?:\.|\s|$)", re.M)

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import raft_tpu_torch
for m in pkgutil.walk_packages(raft_tpu_torch.__path__, "raft_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""


@pytest.fixture(scope="module")
def probed_modules():
    """The modules a fresh interpreter holds after importing every module
    of the port and chip_smoke.py."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_import_pulls_in_no_jax_and_no_jax_package(probed_modules):
    mods = probed_modules
    assert "raft_tpu_torch" in mods and "chip_smoke" in mods
    bad = [m for m in mods if FORBIDDEN.match(m)]
    assert not bad, bad


def test_probe_covers_the_sweep_modules(probed_modules):
    """The batched sweeps and the precision ladder are among the probed
    (and so JAX-free) modules."""
    for name in ("raft_tpu_torch.parallel.sweep",
                 "raft_tpu_torch.parallel.variants",
                 "raft_tpu_torch.ops.precision",
                 "raft_tpu_torch.ops.kernels._build"):
        assert name in probed_modules, name


def test_probe_covers_the_serve_modules(probed_modules):
    """The serving path (the service, its WAL and mirror, the result
    store, the HTTP front door and the command line) is among the probed
    (and so JAX-free) modules."""
    for name in ("raft_tpu_torch.serve.service",
                 "raft_tpu_torch.serve.journal",
                 "raft_tpu_torch.serve.replica",
                 "raft_tpu_torch.serve.resultstore",
                 "raft_tpu_torch.serve.http",
                 "raft_tpu_torch.serve.__main__"):
        assert name in probed_modules, name


def test_probe_covers_the_potential_flow_modules(probed_modules):
    """The WAMIT I/O, the panel mesher, the native BEM wrapper and the
    shared potential-flow cases are among the probed modules."""
    for name in ("raft_tpu_torch.io.wamit",
                 "raft_tpu_torch.io.mesh",
                 "raft_tpu_torch.io.bem_native",
                 "raft_tpu_torch.models.potflow_cases"):
        assert name in probed_modules, name


def test_probe_covers_the_codesign_modules(probed_modules):
    """The implicit-diff gradient layer and its shared cases are among
    the probed modules."""
    for name in ("raft_tpu_torch.parallel.optimize",
                 "raft_tpu_torch.models.codesign_cases"):
        assert name in probed_modules, name


def test_probe_covers_the_descent_modules(probed_modules):
    """The optimizers, the descent and its shared cases are among the
    probed modules."""
    for name in ("raft_tpu_torch.parallel.optimizers",
                 "raft_tpu_torch.parallel.optimize",
                 "raft_tpu_torch.models.descent_cases"):
        assert name in probed_modules, name


def test_probe_covers_the_partition_modules(probed_modules):
    """The partition layer and its shared cases are among the probed
    modules."""
    for name in ("raft_tpu_torch.parallel.partition",
                 "raft_tpu_torch.models.partition_cases"):
        assert name in probed_modules, name


_GROUP_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import raft_tpu_torch
for m in pkgutil.walk_packages(raft_tpu_torch.__path__, "raft_tpu_torch."):
    importlib.import_module(m.name)
import torch.distributed as dist
print(dist.is_available() and dist.is_initialized())
"""


def test_import_opens_no_process_group():
    """Importing every module of the port opens no ``torch.distributed``
    process group, even with the multi-process knobs set: only
    ``partition.ensure_distributed`` does."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RAFT_TPU_DIST="1", RAFT_TPU_COORDINATOR="localhost:1",
               RAFT_TPU_NUM_PROCESSES="2", RAFT_TPU_PROCESS_ID="0")
    out = subprocess.run([sys.executable, "-c",
                          _GROUP_PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "raft_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        src = f.read()
    assert not IMPORT_RE.findall(src), path


def test_forbidden_pattern_spares_the_port():
    assert FORBIDDEN.match("raft_tpu") and FORBIDDEN.match("raft_tpu.model")
    assert FORBIDDEN.match("jax.numpy") and FORBIDDEN.match("jaxlib")
    assert FORBIDDEN.match("optax") and FORBIDDEN.match("optax._src.alias")
    assert not FORBIDDEN.match("raft_tpu_torch")
    assert not FORBIDDEN.match("raft_tpu_torch.model")
