"""The PyTorch port (paddle_tpu_torch) stands alone: importing every one
of its modules pulls in neither JAX nor any module of paddle_tpu."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "paddle_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]

_PROBE = """
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(len(names))
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax_and_no_paddle_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_source_names_no_jax_or_paddle_tpu_import(path):
    """Static twin of the probe above, file by file (a lazy import
    inside a function would escape the import-time probe)."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{path}:{node.lineno} imports {root}"


@pytest.mark.parametrize("path", [
    "paddle_tpu_torch/models/transformer.py",
    "paddle_tpu_torch/ops/beam_search.py",
    "paddle_tpu_torch/nn/transformer.py",
    "paddle_tpu_torch/ops/cuda/flash_attention.py",
])
def test_the_nmt_slice_modules_are_checked(path):
    """The Transformer NMT slice's modules are among the files the two
    checks above walk (the probe imports every module of the package)."""
    assert path in PORT_FILES
    name = path[:-3].replace("/", ".")
    proc = subprocess.run(
        [sys.executable, "-c", f"import {name}, sys; bad = [n for n in "
         f"sys.modules if n.split('.')[0] in ('jax', 'jaxlib', "
         f"'paddle_tpu')]; assert not bad, bad"],
        cwd=str(REPO), capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
