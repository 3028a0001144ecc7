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
from repro_torch import verify
from repro_torch.verify import golden
from repro_torch.launch import costmodel

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


def test_the_scan_covers_the_planning_layer():
    """The AST scan above reads the modules this layer adds."""
    for rel in ("models/sharding.py", "launch/roofline.py",
                "launch/dryrun.py", "launch/costmodel.py", "launch/mesh.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


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
    # the accuracy harness (repro_torch.verify) and its golden CLI
    with pytest.raises((RuntimeError, AssertionError)):
        verify.matern_problem(64, "weak")
    with pytest.raises((RuntimeError, AssertionError)):
        verify.spd_matrix(0, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        verify.attention_problem(0, 1, 1, 8, 8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        verify.sweep_kernels()
    with pytest.raises((RuntimeError, AssertionError)):
        interop.problem_from_numpy("n8_weak", 8, 4, "weak", [1.0, 0.03, 0.5],
                                   np.zeros((8, 2)), np.zeros(8),
                                   np.eye(8))
    with pytest.raises((RuntimeError, AssertionError)):
        golden.main(["--check"])
    # the static and concurrency gate, python -m repro_torch.analysis:
    # --device defaults to cuda; only --device cpu runs here
    from repro_torch.analysis import cli as analysis_cli
    with pytest.raises((RuntimeError, AssertionError)):
        analysis_cli.main(["--check"])
    with pytest.raises((RuntimeError, AssertionError)):
        analysis_cli.main(["--check", "--concurrency"])
    assert analysis_cli.main(["--lint-only", "--device", "cpu"]) == 0
    # LM training: the state, the data source and both entry points
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.launch import train as launch_train
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch import train_lm
    with pytest.raises((RuntimeError, AssertionError)):
        init_train_state(torch.Generator(), SMOKE, TrainConfig())
    with pytest.raises((RuntimeError, AssertionError)):
        SyntheticTokenSource(SMOKE, DataConfig()).batch_at(0)
    with pytest.raises((RuntimeError, AssertionError)):
        launch_train.main(["--arch", "llama3.2-1b", "--steps", "1"])
    # the planning layer's allocator trace measures the card only; the
    # dry-run touches no device at all (tests/test_torch_dryrun.py)
    from repro_torch.launch import peak_trace
    with pytest.raises(RuntimeError):
        peak_trace.main([])
    with pytest.raises((RuntimeError, AssertionError)):
        train_lm.main(["--steps", "1"])


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


# ----------------------------------------------------------------------
# chip_smoke.py's phase 11 arithmetic (it runs on the card only)
# ----------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_scale_peak_reckoning():
    """11 (b)'s predicted peak at 40,960, nb = 1,024: Sigma (4 n^2) and
    L_ref (8 n^2), then the pair's tiles (2.25 n^2), a step-0 U in fp64
    (7.6 n^2) and its fp64 factor (8 n^2): 29.85 n^2 = 46.6 GiB (measured
    on the card 29.76 n^2, 46.50 GiB); under 70 GiB, so n stays."""
    cs = _chip_smoke()
    n, nb = 40_960, 1_024
    peak = costmodel.scale_peak_bytes(n, nb)
    tiles = (8 * 79 + 4 * (820 - 79)) * nb * nb
    assert peak == 12 * n * n + tiles + 8 * (n - nb) ** 2 + 8 * n * n
    assert peak / 2**30 == pytest.approx(46.64, abs=0.01)
    assert cs.scale_n(n, nb, 70.0) == n
    # the oracle's moment (Sigma, upcast, L_ref: 20 n^2) is below the pair's
    assert peak > 20 * n * n


@pytest.mark.parametrize("limit", [30.0, 45.0, 46.0])
def test_chip_smoke_scale_cuts_n_to_fit(limit):
    cs = _chip_smoke()
    n = cs.scale_n(40_960, 1_024, limit)
    assert n % 1_024 == 0 and n < 40_960
    assert costmodel.scale_peak_bytes(n, 1_024) / 2**30 <= limit
    assert costmodel.scale_peak_bytes(n + 1_024, 1_024) / 2**30 > limit


def _scale_records(**over):
    """Synthetic scale-leg records of one problem (the mixed record past
    its weak bound, as measured at 40,960), metrics overridden by record:
    pair={...}, mixed={...}, full={...}, dst={...}."""
    base = {"full": ("chol/tile/full_f32", 3e-6), "pair":
            ("chol/tile/paper_f64f32_t2", 7e-7), "mixed":
            ("chol/tile/mixed_f32bf16_t2", 1.2e-2), "dst": ("chol/dst/t2", 0.48)}
    out = []
    for key, (prefix, fr) in base.items():
        rec = {"id": f"{prefix}/n40960_weak", "factor_rel": fr,
               "backward_rel": fr / 10, "loglik_drift": fr / 100}
        rec.update(over.get(key, {}))
        out.append(rec)
    return out


NAN = float("nan")


@pytest.mark.parametrize("over,fails", [
    ({}, False),
    ({"mixed": {"factor_rel": NAN, "loglik_drift": NAN}}, False),  # C 12: reported
    ({"pair": {"loglik_drift": 2.4e-6}}, False),  # past its 1e-6: reported
    ({"full": {"backward_rel": NAN}}, True),
    ({"pair": {"factor_rel": NAN}}, True),
    ({"pair": {"loglik_drift": 2e-4}}, True),
    ({"dst": {"factor_rel": 0.1}}, True),
])
def test_chip_smoke_scale_requires(over, fails):
    """11 (b)'s requires: full(fp32) and the pair finite, the pair's drift
    <= 1e-4, DST 10x the mixed record's factor_rel where that is finite."""
    cs = _chip_smoke()
    assert bool(cs.scale_failures(_scale_records(**over), 1e-4)) == fails


def _grid_record(rid, **metrics):
    return {"id": rid, "kind": "cholesky", "mode": "three_tier",
            "pair": "f32/bf16/f8e4m3", "diag_thick": 1, "regime": "strong",
            "n": 384, "factor_rel": 1e-2, "backward_rel": 1e-3,
            "loglik_drift": 1e-3, **metrics}


@pytest.mark.parametrize("kernel,plain,unshared", [
    ({}, {}, 0),                                               # within bounds
    ({"factor_rel": NAN}, {"factor_rel": NAN}, 0),             # both NaN
    ({"factor_rel": NAN}, {"factor_rel": 1e-2}, 1),            # kernels only
    ({"loglik_drift": 0.2}, {"loglik_drift": 0.06}, 0),        # both near
    ({"loglik_drift": 0.2}, {"loglik_drift": 0.04}, 1),        # plain < bound/2
    ({"loglik_drift": 0.2, "factor_rel": NAN}, {"factor_rel": NAN}, 1),
])
def test_chip_smoke_unshared_violations(kernel, plain, unshared):
    """11 (a) gates on registry violations that the plain twin does not
    share (three_tier's bound: loglik_drift 0.1)."""
    cs = _chip_smoke()
    rid = "chol/tile/three_tier_t1_t3/n384_strong"
    got = cs.unshared_violations([_grid_record(rid, **kernel)],
                                 [_grid_record(rid, **plain)])
    assert len(got) == unshared
