"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, its entry points default to the card, and chip_smoke.py refuses
to run without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs.llama3_2_1b import SMOKE
from repro_torch.covariance import make_dataset
from repro_torch.models import init_cache, init_lm
from repro_torch.serve_lm import generate

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every subpackage was imported


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    locs = np.random.default_rng(0).uniform(size=(64, 2))
    with pytest.raises((RuntimeError, AssertionError)):
        interop.dataset_from_numpy(locs, np.zeros(64), [1.0, 0.1, 0.5])
    with pytest.raises((RuntimeError, AssertionError)):
        interop.banded_from_numpy(np.zeros((2, 1, 4, 4), np.float32),
                                  np.zeros((2, 2, 4, 4), np.float32),
                                  lo="bfloat16")
    with pytest.raises((RuntimeError, AssertionError)):
        make_dataset(torch.Generator(device="cuda"), 64, [1.0, 0.1, 0.5],
                     nu_static=0.5)
    with pytest.raises((RuntimeError, AssertionError)):
        init_lm(torch.Generator(), SMOKE)
    with pytest.raises((RuntimeError, AssertionError)):
        init_cache(SMOKE, 1, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        interop.lm_params_from_numpy({"embed": np.zeros((4, 2), np.float32)})


def test_generate_computes_on_the_device_of_its_inputs():
    # generate takes tensors: on CPU tensors it runs there, kernels unused
    params = init_lm(torch.Generator().manual_seed(0), SMOKE, device="cpu")
    ids, cache = generate(params, SMOKE, torch.zeros((1, 4), dtype=torch.long),
                          2, compute_dtype=torch.float32)
    assert ids.device.type == "cpu" and ids.shape == (1, 2)
    assert cache["b0"]["k"].device.type == "cpu"


def test_interop_carries_data_and_policy_on_request():
    ds = interop.dataset_from_numpy(np.ones((8, 2)), np.arange(8),
                                    [1.0, 0.1, 0.5], device="cpu")
    assert ds.locs.dtype == torch.float32 and ds.z.shape == (8,)
    pol = interop.policy_from_fields("three_tier", "float32", "bfloat16", 1,
                                     lo2="float8_e4m3fn", diag_thick2=3)
    assert pol.lo2 == torch.float8_e4m3fn and pol.solve_dtype == torch.float32
    off = np.array([[0.1, 1.5]], np.float32)
    band, off_t = interop.banded_from_numpy(np.zeros((1, 1, 1, 1), np.float32),
                                            off, lo=torch.bfloat16, device="cpu")
    assert off_t.dtype == torch.bfloat16 and band.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:  # alone, without the rest of the repository
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
