"""Architecture registry: full configs and smoke configs.

``ARCHS`` lists every architecture the JAX package supports and
``PORTED`` maps each to its config module here; an arch outside
``PORTED`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "zamba2-7b",
    "minitron-8b",
    "deepseek-67b",
    "gemma-7b",
    "granite-20b",
    "whisper-medium",
    "deepseek-v2-lite-16b",
    "grok-1-314b",
    "llama-3.2-vision-11b",
    "xlstm-125m",
]

PORTED = {"minitron-8b": "minitron_8b", "zamba2-7b": "zamba2_7b",
          "gemma-7b": "gemma_7b", "granite-20b": "granite_20b",
          "deepseek-67b": "deepseek_67b", "xlstm-125m": "xlstm_125m",
          "deepseek-v2-lite-16b": "deepseek_v2_lite_16b", "grok-1-314b": "grok_1_314b",
          "whisper-medium": "whisper_medium",
          "llama-3.2-vision-11b": "llama_3_2_vision_11b"}


def _load(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet; the port builds "
            f"{sorted(PORTED)} (see ROADMAP.md queue 1)")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch]}")


def get_config(arch: str, **overrides):
    cfg = _load(arch).CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides):
    cfg = _load(arch).SMOKE
    return cfg.replace(**overrides) if overrides else cfg


def list_archs():
    """Every architecture the JAX package supports."""
    return list(ARCHS)
