"""Architecture config registry (port of ``repro/configs/__init__.py``).

The port carries the configurations its slices run: ``tide_tiny`` (the
CPU parity model), the attention mixers ``glm4_9b`` and
``phi3_medium_14b`` (SwiGLU), ``starcoder2_7b`` and ``starcoder2_15b``
(the GELU FFN), ``granite_moe_3b_a800m`` and ``gpt_oss_120b`` (the MoE
FFN, ``models/moe.py``), and ``deepseek_v3_671b`` (multi-head latent
attention, ``models/mla.py``, with a dense prologue before its MoE
body).  ``get(name)`` / ``get_reduced(name)`` look
them up by module name or dashed alias.
"""
from __future__ import annotations

import importlib

ARCHS = ["glm4_9b", "phi3_medium_14b", "starcoder2_15b",
         "granite_moe_3b_a800m", "starcoder2_7b", "gpt_oss_120b",
         "deepseek_v3_671b", "tide_tiny"]

_ALIASES = {"glm4-9b": "glm4_9b", "phi3-medium-14b": "phi3_medium_14b",
            "starcoder2-15b": "starcoder2_15b",
            "granite-moe-3b-a800m": "granite_moe_3b_a800m",
            "starcoder2-7b": "starcoder2_7b", "gpt-oss-120b": "gpt_oss_120b",
            "deepseek-v3-671b": "deepseek_v3_671b", "tide-tiny": "tide_tiny"}


def _module(name: str):
    key = _ALIASES.get(name, name.replace("-", "_"))
    if key not in ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP queue 1 "
            "item 8: the Mamba, RWKV-6 and cross-attention families)")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).REDUCED
