"""The port stands alone: nothing under src/repro_torch (nor chip_smoke.py)
imports jax or the JAX package, nor msgpack or ml_dtypes (the GPU
machine has neither; the checkpoint codec is the port's own), every port
module imports with jax, msgpack and ml_dtypes blocked, and the entry
points refuse to run without a CUDA device unless the caller asks for the
CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack",
                           "ml_dtypes"), f"{path}: imports {mod}"


def test_every_port_module_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['msgpack'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import engine
    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
    from repro_torch.launch import train_byzantine
    from repro_torch.models.workload import lm_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = engine.EngineConfig(n=4, d=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_setup("albert_large")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_byzantine.main(["--model", "albert_large", "--steps", "1"])
    params = {"w": torch.zeros(10)}
    with pytest.raises(RuntimeError, match="CUDA"):
        BTARDTrainer(lambda p, b: p["w"].sum(), params, None,
                     TrainerConfig(n_peers=4))
    state = engine.init_state(cfg, device="cpu")
    assert state.active.device.type == "cpu"
    tr = BTARDTrainer(lambda p, b: p["w"].sum(), params, None,
                      TrainerConfig(n_peers=4, device="cpu"))
    assert tr.params.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """No result line without a CUDA device, nor from a directory that holds
    chip_smoke.py and nothing else of the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
