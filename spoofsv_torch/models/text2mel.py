"""Text2Mel ("melSyn"): multi-speaker DCTTS generator.

Port of :mod:`spoofsv_tpu.models.text2mel`. The teacher-forced forward is one
parallel pass; inference steps :meth:`MelSyn.decode_step` — one frame with
causal-conv caches and incremental monotonic attention held to the window
``[pma, pma+2]``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from spoofsv_torch.models.layers import (Conv1x1, HighwayConv,
                                         HighwayDilationStack, LayerNorm,
                                         functional_dropout, highway_pair)

ATT_MASK_VALUE = -2.0 ** 32  # reference models/TTSModel.py:284,286


class _TextEmbedding(nn.Module):
    """One-hot → ``Linear(vocab, emb)``, evaluated as a column gather."""

    def __init__(self, vocab_len: int, emb_dim: int):
        super().__init__()
        self.W = nn.Linear(vocab_len, emb_dim)
        nn.init.kaiming_normal_(self.W.weight, nonlinearity="relu")
        nn.init.zeros_(self.W.bias)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.W.weight.t()[ids] + self.W.bias


class TextEncoder(nn.Module):
    """Text → (K, V), each (B, N, hidden)."""

    def __init__(self, vocab_len: int, text_emb_dim: int = 128,
                 hidden_dim: int = 256, dropout_rate: float = 0.0):
        super().__init__()
        d2 = 2 * hidden_dim
        self.dropout_rate = dropout_rate
        self.textemb_layer = _TextEmbedding(vocab_len, text_emb_dim)
        self.conv1 = Conv1x1(text_emb_dim, d2)
        self.ln1 = LayerNorm(d2)
        self.conv2 = Conv1x1(d2, d2)
        self.ln2 = LayerNorm(d2)
        self.hci1 = HighwayDilationStack(d2, False, dropout_rate)
        self.hci2 = HighwayDilationStack(d2, False, dropout_rate)
        self.hc1 = HighwayConv(d2, 3, 1, False, dropout_rate)
        self.hc2 = HighwayConv(d2, 3, 1, False, dropout_rate)
        self.hc3 = HighwayConv(d2, 1, 1, False, dropout_rate)
        self.hc4 = HighwayConv(d2, 1, 1, False, dropout_rate)

    def forward(self, text_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``text_ids``: (B, N) int → K, V each (B, N, hidden)."""
        p, tr = self.dropout_rate, self.training
        x = self.textemb_layer(text_ids.long())
        x = torch.relu(self.ln1(self.conv1(x)))
        x = functional_dropout(x, p, tr)
        x = functional_dropout(self.ln2(self.conv2(x)), p, tr)
        x = self.hci2(self.hci1(x))
        x = highway_pair(self.hc1, self.hc2, x)
        x = highway_pair(self.hc3, self.hc4, x)
        K, V = x.chunk(2, dim=-1)
        return K, V


class AudioEncoder(nn.Module):
    """Mel prefix → query Q, causal + speaker-conditioned."""

    def __init__(self, freq_bins: int = 80, hidden_dim: int = 256,
                 condition: bool = True, spk_emb_dim: int = 200,
                 dropout_rate: float = 0.0):
        super().__init__()
        h = hidden_dim
        self.condition = condition
        self.dropout_rate = dropout_rate
        if condition:
            self.fc1 = nn.Linear(spk_emb_dim, h)
            self.fc2 = nn.Linear(spk_emb_dim, h)
        self.conv1 = Conv1x1(freq_bins, h)
        self.ln1 = LayerNorm(h)
        self.conv2 = Conv1x1(h, h)
        self.ln2 = LayerNorm(h)
        self.conv3 = Conv1x1(h, h)
        self.ln3 = LayerNorm(h)
        self.hci1 = HighwayDilationStack(h, True, dropout_rate)
        self.hci2 = HighwayDilationStack(h, True, dropout_rate)
        self.hc1 = HighwayConv(h, 3, 3, True, dropout_rate)
        self.hc2 = HighwayConv(h, 3, 3, True, dropout_rate)

    def _front(self, x: torch.Tensor, spk: Optional[torch.Tensor],
               training: bool) -> torch.Tensor:
        """The shared 1×1-conv front; ``x`` may be (B, T, F) or (B, F)."""
        p = self.dropout_rate
        x = self.conv1(x)
        if self.condition:
            s = self.fc1(spk)
            x = x + (s[:, None, :] if x.dim() == 3 else s)
        x = torch.relu(self.ln1(x))
        x = functional_dropout(x, p, training)
        x = torch.relu(self.ln2(self.conv2(x)))
        x = functional_dropout(x, p, training)
        x = self.conv3(x)
        if self.condition:
            s = self.fc2(spk)
            x = x + (s[:, None, :] if x.dim() == 3 else s)
        return functional_dropout(self.ln3(x), p, training)

    def forward(self, mel: torch.Tensor, spk: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``mel``: (B, T, freq_bins); ``spk``: (B, spk_emb_dim) → Q (B, T, h)."""
        x = self._front(mel, spk, self.training)
        x = self.hci2(self.hci1(x))
        return highway_pair(self.hc1, self.hc2, x)

    def init_cache(self, batch: int, device=None, dtype=None):
        return (self.hci1.init_cache(batch, device, dtype),
                self.hci2.init_cache(batch, device, dtype),
                self.hc1.init_cache(batch, device, dtype),
                self.hc2.init_cache(batch, device, dtype))

    def step(self, mel_t: torch.Tensor, spk: Optional[torch.Tensor], cache):
        """One frame; ``mel_t``: (B, freq_bins) → (Q_t (B, h), cache)."""
        x = self._front(mel_t, spk, False)
        c1, c2, c3, c4 = cache
        x, c1 = self.hci1.step(x, c1)
        x, c2 = self.hci2.step(x, c2)
        x, c3 = self.hc1.step(x, c3)
        x, c4 = self.hc2.step(x, c4)
        return x, (c1, c2, c3, c4)


class AudioDecoder(nn.Module):
    """[R; Q] → mel frame probabilities."""

    def __init__(self, freq_bins: int = 80, hidden_dim: int = 256,
                 dropout_rate: float = 0.0):
        super().__init__()
        h = hidden_dim
        self.dropout_rate = dropout_rate
        self.conv1 = Conv1x1(2 * h, h)
        self.ln1 = LayerNorm(h)
        self.hci = HighwayDilationStack(h, True, dropout_rate)
        self.hc1 = HighwayConv(h, 3, 1, True, dropout_rate)
        self.hc2 = HighwayConv(h, 3, 1, True, dropout_rate)
        self.conv2 = Conv1x1(h, h)
        self.ln2 = LayerNorm(h)
        self.conv3 = Conv1x1(h, h)
        self.ln3 = LayerNorm(h)
        self.conv4 = Conv1x1(h, h)
        self.ln4 = LayerNorm(h)
        self.conv5 = Conv1x1(h, freq_bins)
        self.ln5 = LayerNorm(freq_bins)

    def _tail(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        p = self.dropout_rate
        x = functional_dropout(torch.relu(self.ln2(self.conv2(x))), p, training)
        x = torch.relu(self.ln3(self.conv3(x)))
        if p > 0:
            # the dropout variant uses p=0.04 here (TTSModel_dropout.py:229)
            x = functional_dropout(x, 0.04, training)
        x = torch.relu(self.ln4(self.conv4(x)))
        x = functional_dropout(x, p, training)
        return torch.sigmoid(self.ln5(self.conv5(x)))

    def forward(self, rq: torch.Tensor) -> torch.Tensor:
        """``rq``: (B, T, 2h) → (B, T, freq_bins) in (0, 1)."""
        x = self.ln1(self.conv1(rq))
        x = functional_dropout(x, self.dropout_rate, self.training)
        x = highway_pair(self.hc1, self.hc2, self.hci(x))
        return self._tail(x, self.training)

    def init_cache(self, batch: int, device=None, dtype=None):
        return (self.hci.init_cache(batch, device, dtype),
                self.hc1.init_cache(batch, device, dtype),
                self.hc2.init_cache(batch, device, dtype))

    def step(self, rq_t: torch.Tensor, cache):
        x = self.ln1(self.conv1(rq_t))
        c1, c2, c3 = cache
        x, c1 = self.hci.step(x, c1)
        x, c2 = self.hc1.step(x, c2)
        x, c3 = self.hc2.step(x, c3)
        return self._tail(x, False), (c1, c2, c3)


class DecodeState(NamedTuple):
    """Carry of the autoregressive decoder."""
    y_prev: torch.Tensor     # (B, freq_bins) — last emitted mel frame
    pma: torch.Tensor        # (B,) int64 — previous max-attention text position
    enc_cache: Any
    dec_cache: Any


class MelSyn(nn.Module):
    """Text2Mel generator."""

    def __init__(self, vocab_len: int, condition: bool = True,
                 spk_emb_dim: int = 200, text_emb_dim: int = 128,
                 freq_bins: int = 80, hidden_dim: int = 256,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.condition = condition
        self.freq_bins = freq_bins
        self.hidden_dim = hidden_dim
        self.text_encoder = TextEncoder(vocab_len, text_emb_dim, hidden_dim,
                                        dropout_rate)
        self.audio_encoder = AudioEncoder(freq_bins, hidden_dim, condition,
                                          spk_emb_dim, dropout_rate)
        self.audio_decoder = AudioDecoder(freq_bins, hidden_dim, dropout_rate)

    @property
    def att_scale(self) -> float:
        return 1.0 / math.sqrt(self.hidden_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.audio_decoder.conv1.weight.dtype

    def forward(self, mel_inputs: torch.Tensor, text_ids: torch.Tensor,
                spk_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced parallel forward. ``mel_inputs``: (B, T, F)
        shifted-right mel; returns (Y (B, T, F), A (B, N, T))."""
        K, V = self.text_encoder(text_ids)
        Q = self.audio_encoder(mel_inputs, spk_emb)
        scores = torch.einsum("bnh,bth->bnt", K, Q) * self.att_scale
        A = torch.softmax(scores.float(), dim=1).to(scores.dtype)
        R = torch.einsum("bnh,bnt->bth", V, A)
        Y = self.audio_decoder(torch.cat([R, Q], dim=-1))
        return Y, A

    # -- inference -----------------------------------------------------------
    def encode_text(self, text_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.text_encoder(text_ids)

    def init_state(self, batch: int, device=None) -> DecodeState:
        dt = self.dtype
        return DecodeState(
            y_prev=torch.zeros(batch, self.freq_bins, device=device, dtype=dt),
            pma=torch.zeros(batch, dtype=torch.long, device=device),
            enc_cache=self.audio_encoder.init_cache(batch, device, dt),
            dec_cache=self.audio_decoder.init_cache(batch, device, dt),
        )

    def decode_step(self, state: DecodeState, K: torch.Tensor, V: torch.Tensor,
                    spk_emb: Optional[torch.Tensor],
                    text_mask: Optional[torch.Tensor] = None,
                    monotonic: bool = True
                    ) -> Tuple[DecodeState, Tuple[torch.Tensor, torch.Tensor]]:
        """One AR frame with forced monotonic attention.
        Returns (new_state, (y_t (B, F), a_t (B, N)))."""
        q_t, enc_cache = self.audio_encoder.step(state.y_prev, spk_emb,
                                                 state.enc_cache)
        scores = torch.einsum("bnh,bh->bn", K, q_t) * self.att_scale
        pos = torch.arange(K.shape[1], device=K.device)[None, :]
        if monotonic:
            pma = state.pma[:, None]
            scores = scores.masked_fill((pos < pma) | (pos > pma + 2), ATT_MASK_VALUE)
        if text_mask is not None:
            scores = scores.masked_fill(~text_mask, ATT_MASK_VALUE)
        a_t = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        pma = torch.argmax(a_t, dim=-1)
        r_t = torch.einsum("bnh,bn->bh", V, a_t)
        y_t, dec_cache = self.audio_decoder.step(torch.cat([r_t, q_t], dim=-1),
                                                 state.dec_cache)
        return (DecodeState(y_prev=y_t, pma=pma, enc_cache=enc_cache,
                            dec_cache=dec_cache), (y_t, a_t))
