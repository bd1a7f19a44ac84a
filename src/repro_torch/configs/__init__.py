"""Architecture registry: ``get_config(arch)`` resolves here.

The port registers the architectures it can run; the others join as their
families are ported.
"""
from importlib import import_module

from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES

_MODULES = {
    "smollm-360m": "smollm_360m",
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}
ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return import_module(f".{_MODULES[arch]}", __package__).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "ARCHS", "get_config", "get_smoke"]
