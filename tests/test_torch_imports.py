"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the port's entry
points refuse to run without a CUDA card unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.serving, repro_torch.models, "
            "repro_torch.kernels.ops, repro_torch.kernels.rmsnorm, "
            "repro_torch.kernels.paged_attention, repro_torch.kernels.decode_attention, "
            "repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import build_system
    from repro_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system()
    assert ServingEngine(cfg, device="cpu", max_seq=32).device.type == "cpu"
