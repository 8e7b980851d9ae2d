"""Typed configuration, shared with the JAX package.

``spoofsv_tpu.config`` is plain dataclasses and imports no jax, so the port
uses it as it is (importing ``spoofsv_tpu.config`` loads only that module).
"""

from spoofsv_tpu.config import Config, NormConfig, STFTConfig, TPUConfig

__all__ = ["Config", "NormConfig", "STFTConfig", "TPUConfig"]
