"""Boundaries of the PyTorch port.

* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``repro``, checked in a fresh interpreter.
* Without a CUDA card the entry points raise instead of running on the CPU,
  and ``chip_smoke.py`` fails without printing a result, as it does when
  the rest of the repository is missing.
* ``interop`` carries the JAX package's stacked layer axis both ways.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module of the port was imported


def test_entry_points_default_to_cuda(no_cuda):
    cfg = get_smoke_config("llava-1.5-7b")
    with pytest.raises((RuntimeError, AssertionError)):
        model_lib.init_backbone(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main([])
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(["--rounds", "1", "--clients", "2", "--local-steps", "1",
                    "--examples-per-client", "8", "--batch-size", "4", "--seq-len", "8"])


def test_chip_smoke_fails_without_cuda(no_cuda):
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_interop_round_trips_stacked_layers():
    jcfg = jax_smoke_config("llava-1.5-7b")
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(3), jcfg))
    params = interop.backbone_from_numpy(get_smoke_config("llava-1.5-7b"), tree, "cpu")
    assert len(params["layers"]) == jcfg.n_layers
    np.testing.assert_array_equal(params["layers"][1]["mlp"]["w_up"].numpy(),
                                  tree["layers"]["mlp"]["w_up"][1])
    back = interop.backbone_to_numpy(params)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_interop_bfloat16_bits():
    a = np.asarray(jax.numpy.asarray([1.0, -2.5, 3.1415927, 1e-3], jax.numpy.bfloat16))
    t = interop.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.tensor_to_numpy(t), a.astype(np.float32))


def test_interop_rejects_wrong_layer_count():
    jcfg = jax_smoke_config("llava-1.5-7b")
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(3), jcfg))
    with pytest.raises(ValueError, match="n_layers"):
        interop.backbone_from_numpy(get_smoke_config("llava-1.5-7b", n_layers=3), tree, "cpu")
