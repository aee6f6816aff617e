"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or ``msgpack`` (which the
card's machine lacks), and the port's entry points refuse to run
without a CUDA card unless asked for the CPU."""

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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_msgpack_import(path):
    assert "msgpack" not in set(_imported_roots(path)), \
        f"{path.relative_to(ROOT)} imports msgpack"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.serving, repro_torch.models, "
            "repro_torch.kernels.ops, repro_torch.kernels.rmsnorm, "
            "repro_torch.kernels.paged_attention, repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.awq_matmul, repro_torch.kernels.ssm_scan, "
            "repro_torch.models.ssm, repro_torch.configs.zamba2_7b, "
            "repro_torch.models.xlstm, repro_torch.configs.xlstm_125m, "
            "repro_torch.serving.speculative, repro_torch.serving.fleet, "
            "repro_torch.serving.scheduler, repro_torch.core.desktop, "
            "repro_torch.serving.quantize, repro_torch.models.moe, repro_torch.models.mla, "
            "repro_torch.configs.deepseek_v2_lite_16b, repro_torch.configs.grok_1_314b, "
            "repro_torch.models.encdec, repro_torch.configs.whisper_medium, "
            "repro_torch.configs.llama_3_2_vision_11b, "
            "repro_torch.serving.prng, repro_torch.launch.serve, "
            "repro_torch.training, repro_torch.kernels.flash_attention, "
            "repro_torch.launch.train; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')); print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import build_system
    from repro_torch.core.desktop import build_desktop_system
    from repro_torch.serving import EngineFleet, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(kv_dtype="int8", quantize_mlp=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(hpc_arch="zamba2-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(hpc_arch="deepseek-v2-lite-16b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(hpc_arch="grok-1-314b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(hpc_arch="whisper-medium")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(hpc_arch="llama-3.2-vision-11b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_desktop_system()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineFleet.build(cfg, replicas=2)
    assert ServingEngine(cfg, device="cpu", max_seq=32).device.type == "cpu"
