"""The PyTorch port stands alone: importing dsrc_tpu_torch, every one of its
modules (the record API dsrc_tpu_torch.archive_api, the examples and the
multi-device modules parallel/mesh.py and parallel/distributed.py among
them), chip_smoke.py and the k1, k3, k4 and k5_variants.py scripts loads
neither JAX nor anything of dsrc_tpu.

Checked in a subprocess, because this test process has JAX loaded already
(tests/conftest.py)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import dsrc_tpu_torch
for m in pkgutil.walk_packages(dsrc_tpu_torch.__path__, "dsrc_tpu_torch."):
    if not m.name.endswith("__main__"):          # __main__ runs the CLI
        importlib.import_module(m.name)
for script in ("chip_smoke", "k1_variants", "k3_variants", "k4_variants",
               "k5_variants"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from dsrc_tpu_torch.api import DsrcModule
DsrcModule(device="cpu")
import dsrc_tpu_torch.archive_api
from dsrc_tpu_torch import DsrcArchive
DsrcArchive(device="cpu")
assert "dsrc_tpu_torch.archive_api" in sys.modules
assert "dsrc_tpu_torch.examples.example2" in sys.modules
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "dsrc_tpu"))
print("LOADED", len([n for n in sys.modules
                     if n.startswith("dsrc_tpu_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_nothing_of_dsrc_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 20
    assert lines["BAD"] == "[]"


def test_mesh_and_distributed_modules_load_no_jax():
    """The multi-device modules on their own: parallel/mesh.py and
    parallel/distributed.py (and api.py, which imports the mesh)."""
    probe = ("import sys\n"
             "import dsrc_tpu_torch.parallel.mesh\n"
             "import dsrc_tpu_torch.parallel.distributed\n"
             "from dsrc_tpu_torch.parallel.distributed import "
             "compress_distributed\n"
             "from dsrc_tpu_torch.api import _mesh_compress_results\n"
             "print(sorted(n for n in sys.modules\n"
             "             if n.split('.')[0] in "
             "('jax', 'jaxlib', 'dsrc_tpu')))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Where torch sees no CUDA device, chip_smoke.py exits non-zero and
    prints no result line."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
