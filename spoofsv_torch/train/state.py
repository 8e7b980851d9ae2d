"""Train states of the ordinary and adversarial trainers.

Port of :mod:`spoofsv_tpu.train.state`: the step counter, the modules (their
parameters are the JAX states' params) and the Adam optimizers (their moments
are the opt states). PyTorch updates them in place.
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


@dataclasses.dataclass
class AdvTrainState:
    """Generator and critic with one Adam each; ``step`` counts G and D steps."""
    step: int
    gen: nn.Module
    gen_optimizer: torch.optim.Optimizer
    disc: nn.Module
    disc_optimizer: torch.optim.Optimizer
