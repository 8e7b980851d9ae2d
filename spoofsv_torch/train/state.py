"""Train state of the ordinary trainer.

Port of :class:`spoofsv_tpu.train.state.TrainState`: the step counter, the
model (its parameters are the JAX state's ``params``) and the optimizer (its
moments are ``opt_state``). PyTorch updates both in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
