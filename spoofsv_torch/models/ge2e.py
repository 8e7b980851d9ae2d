"""GE2E speaker-verification embedder and loss.

Port of :mod:`spoofsv_tpu.models.ge2e` (the reference
``GE2E/speech_embedder_net.py:15-49`` and ``GE2E/utils.py:16-55``). The
embedder is the reference module: ``LSTM_stack`` (``nn.LSTM``, batch first;
cuDNN on the card) and ``projection`` (``nn.Linear``), so a reference state
dict loads with ``strict=True``. The loss is the JAX package's vectorised
form, with its leave-one-out own-speaker centroid.

Reference quirks kept: ``+1e-6`` on every cosine similarity; the loss's
``log(sum(exp(sim)) + 1e-6)``; ``w`` unclamped (the reference's
``torch.clamp(self.w, 1e-6)`` discards its result).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class SpeechEmbedder(nn.Module):
    """(B, frames, nmels) log-mel → (B, proj) L2-normalised d-vectors: the
    last frame of the LSTM stack, projected."""

    def __init__(self, nmels: int = 40, hidden: int = 768, num_layers: int = 3,
                 proj: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.num_layers, self.proj = hidden, num_layers, proj
        self.LSTM_stack = nn.LSTM(nmels, hidden, num_layers=num_layers, batch_first=True)
        self.projection = nn.Linear(hidden, proj)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisation, drawn from ``generator``. flax's
        ``OptimizedLSTMCell`` there takes xavier-normal per gate: each (H, in)
        gate block of the stacked (4H, in) matrices gets its own variance
        ``2 / (in + H)``, not that of the whole stack. The biases are zero and
        the projection lecun-normal (flax's ``Dense`` default). JAX's normals
        are truncated at 2 std and rescaled to keep the variance."""
        h = self.hidden
        for name, p in self.LSTM_stack.named_parameters():
            if name.startswith("bias"):
                p.zero_()
                continue
            for g in range(4):
                _truncated_normal(p[g * h:(g + 1) * h], 2.0 / (p.shape[1] + h), generator)
        _truncated_normal(self.projection.weight, 1.0 / self.hidden, generator)
        self.projection.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.LSTM_stack(x.to(self.projection.weight.dtype))
        e = self.projection(x[:, -1])
        return e / torch.linalg.vector_norm(e, dim=1, keepdim=True)


def _truncated_normal(t: torch.Tensor, variance: float,
                      generator: Optional[torch.Generator]) -> None:
    """``jax.nn.initializers.variance_scaling``'s truncated normal: std
    ``sqrt(variance) / 0.8796`` (the std of a unit normal cut at ±2), cut at ±2 std."""
    std = math.sqrt(variance) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def get_centroids(embeddings: torch.Tensor) -> torch.Tensor:
    """Per-speaker mean over the utterances: (N, M, D) → (N, D)."""
    return embeddings.mean(dim=1)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                              * torch.linalg.vector_norm(b, dim=-1) + 0.0)


def get_cossim(embeddings: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, M, K) cosine similarities ``cos(e_ji, c_k) + 1e-6``. When K == N
    the own-speaker entry ``[j, i, j]`` takes speaker j's centroid without
    utterance i (``GE2E/utils.py:36-46``); with other enrollment centroids
    (K != N) nothing is left out."""
    n, m, _ = embeddings.shape
    plain = _cos(embeddings[:, :, None, :], centroids[None, None, :, :])
    if centroids.shape[0] == n:
        loo = (embeddings.sum(dim=1, keepdim=True) - embeddings) / (m - 1)
        eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)[:, None, :]
        plain = torch.where(eye, _cos(embeddings, loo)[:, :, None], plain)
    return plain + 1e-6


def calc_loss(sim_matrix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contrastive softmax loss of an (N, M, N) similarity tensor
    (``GE2E/utils.py:48-55``): (sum, per-embedding (N, M))."""
    n = sim_matrix.shape[0]
    idx = torch.arange(n, device=sim_matrix.device)
    own = sim_matrix[idx, :, idx]                                     # (N, M): sim[j, i, j]
    lse = torch.log(torch.exp(sim_matrix).sum(dim=2) + 1e-6)
    per_embedding = -(own - lse)
    return per_embedding.sum(), per_embedding


class GE2ELoss(nn.Module):
    """The trainable scale and offset ``(w, b)``, 10 and -5 at the start
    (``GE2E/speech_embedder_net.py:35-49``)."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(10.0))
        self.b = nn.Parameter(torch.tensor(-5.0))

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        sim = self.w * get_cossim(embeddings, get_centroids(embeddings)) + self.b
        return calc_loss(sim)[0]
