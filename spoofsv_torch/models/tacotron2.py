"""Multi-speaker Tacotron 2: NVIDIA/tacotron2's ``model.py`` with SV2TTS's d-vector.

The modules and their ``state_dict`` names are NVIDIA's (``ConvNorm``,
``LinearNorm``, ``Encoder``, ``Prenet``, ``LocationLayer``, ``Attention``,
``Decoder``, ``Postnet``, ``Tacotron2``), so a checkpoint of that schema
loads with ``strict=True``. The one change to the architecture is SV2TTS's
(Jia et al., arXiv:1806.04558, sec. 2.2): the speaker's d-vector is
concatenated to every encoder output, so the attention's memory is
``encoder_embedding_dim + speaker_embedding_dim`` wide, and ``memory_layer``,
both LSTM cells' inputs (through the context), the projection and the gate
take that width.

Inference runs through :class:`spoofsv_torch.infer.synthesize.Tacotron2Synthesizer`:
the encoder here (:meth:`Tacotron2.encode`, with each row's padding kept
out, the BiLSTM over packed lengths), the decoder's rollout in
:mod:`spoofsv_torch.ops.t2_kernel` (one CUDA graph a call on the card), the
postnet here (:meth:`Tacotron2.postnet_apply`). Both fold each BatchNorm
into the convolution before it. The prenet's dropout stays on at inference
(p :data:`PRENET_DROPOUT`, as ``model.py``'s ``Prenet`` has it), its masks
hashed from the call's seeds; the decoder's and the attention's dropouts
(training only) are absent, as is the paper's zoneout.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from spoofsv_torch.config import Tacotron2Config

PRENET_DROPOUT = 0.5   # model.py's Prenet: F.dropout(..., p=0.5, training=True)


class LinearNorm(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class ConvNorm(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _conv_bn(in_ch: int, out_ch: int, k: int) -> nn.Sequential:
    return nn.Sequential(ConvNorm(in_ch, out_ch, k), nn.BatchNorm1d(out_ch))


class Encoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        E = cfg.encoder_embedding_dim
        self.convolutions = nn.ModuleList(
            [_conv_bn(E, E, cfg.encoder_kernel_size) for _ in range(cfg.encoder_n_convolutions)])
        self.lstm = nn.LSTM(E, E // 2, 1, batch_first=True, bidirectional=True)


class Prenet(nn.Module):
    def __init__(self, in_dim: int, sizes: List[int]):
        super().__init__()
        dims = [in_dim] + sizes[:-1]
        self.layers = nn.ModuleList([LinearNorm(i, o, bias=False) for i, o in zip(dims, sizes)])


class LocationLayer(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int, attention_dim: int):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel_size, bias=False)
        self.location_dense = LinearNorm(n_filters, attention_dim, bias=False)


class Attention(nn.Module):
    def __init__(self, rnn_dim: int, memory_dim: int, attention_dim: int, n_filters: int,
                 kernel_size: int):
        super().__init__()
        self.query_layer = LinearNorm(rnn_dim, attention_dim, bias=False)
        self.memory_layer = LinearNorm(memory_dim, attention_dim, bias=False)
        self.v = LinearNorm(attention_dim, 1, bias=False)
        self.location_layer = LocationLayer(n_filters, kernel_size, attention_dim)


class Decoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        M, A, D = cfg.memory_dim, cfg.attention_rnn_dim, cfg.decoder_rnn_dim
        n_mel = cfg.n_mel_channels * cfg.n_frames_per_step
        self.prenet = Prenet(n_mel, [cfg.prenet_dim, cfg.prenet_dim])
        self.attention_rnn = nn.LSTMCell(cfg.prenet_dim + M, A)
        self.attention_layer = Attention(A, M, cfg.attention_dim,
                                         cfg.attention_location_n_filters,
                                         cfg.attention_location_kernel_size)
        self.decoder_rnn = nn.LSTMCell(A + M, D, 1)
        self.linear_projection = LinearNorm(D + M, n_mel)
        self.gate_layer = LinearNorm(D + M, 1, bias=True)


class Postnet(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        C, k, n = cfg.postnet_embedding_dim, cfg.postnet_kernel_size, cfg.postnet_n_convolutions
        n_mel = cfg.n_mel_channels
        self.convolutions = nn.ModuleList(
            [_conv_bn(n_mel if i == 0 else C, n_mel if i == n - 1 else C, k) for i in range(n)])


def fold_conv_bn(seq: nn.Sequential) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``Sequential(ConvNorm, BatchNorm1d)`` in eval as one convolution:
    (weight, bias) folded in float32, then in the module's dtype."""
    conv, bn = seq[0].conv, seq[1]
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * scale[:, None, None]
    b = (conv.bias.float() - bn.running_mean.float()) * scale + bn.bias.float()
    return w.to(conv.weight.dtype), b.to(conv.weight.dtype)


class Tacotron2(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.n_symbols, cfg.symbols_embedding_dim)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.postnet = Postnet(cfg)
        self._folded = None

    def _inference_weights(self):
        """The convolutions with their BatchNorms folded in, and the
        encoder's BiLSTM in float32, built once (call after loading)."""
        if self._folded is None:
            lstm = nn.LSTM(self.encoder.lstm.input_size, self.encoder.lstm.hidden_size, 1,
                           batch_first=True, bidirectional=True).to(self.embedding.weight.device)
            lstm.load_state_dict({k: v.float() for k, v in self.encoder.lstm.state_dict().items()})
            self._folded = {"encoder": [fold_conv_bn(s) for s in self.encoder.convolutions],
                            "postnet": [fold_conv_bn(s) for s in self.postnet.convolutions],
                            "lstm": lstm.eval()}
        return self._folded

    @torch.no_grad()
    def encode(self, ids: torch.Tensor, lengths: torch.Tensor, dvec: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N) ids, their lengths (B,) on the host, (B, S) d-vectors →
        (memory (B, N, E + S), processed memory (B, N, attention_dim)), in
        the model's dtype. Each row's encoder sees its own ids only: the
        padding is zeroed before every convolution and the BiLSTM runs over
        packed lengths (in float32); the d-vector is concatenated at every
        position."""
        fw = self._inference_weights()
        dtype = self.embedding.weight.dtype
        B, N = ids.shape
        valid = (torch.arange(N, device=ids.device)[None, :]
                 < lengths.to(ids.device)[:, None]).to(dtype)
        x = self.embedding(ids).transpose(1, 2)
        for w, b in fw["encoder"]:
            x = torch.relu(F.conv1d(x * valid[:, None], w, b, padding=(w.shape[-1] - 1) // 2))
        x = (x.transpose(1, 2) * valid[:, :, None]).float()
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                                   enforce_sorted=False)
        out, _ = fw["lstm"](packed)
        enc, _ = nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=N)
        memory = torch.cat([enc, dvec.float()[:, None, :].expand(B, N, dvec.shape[-1])], 2)
        memory = memory.to(dtype)
        pm = self.decoder.attention_layer.memory_layer(memory)
        return memory, pm

    @torch.no_grad()
    def postnet_apply(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mel) float32 → the mel plus the postnet's residual, float32
        (the convolutions in the model's dtype)."""
        fw = self._inference_weights()
        x = mel.to(self.embedding.weight.dtype).transpose(1, 2)
        for i, (w, b) in enumerate(fw["postnet"]):
            x = F.conv1d(x, w, b, padding=(w.shape[-1] - 1) // 2)
            if i < len(fw["postnet"]) - 1:
                x = torch.tanh(x)
        return mel.float() + x.transpose(1, 2).float()


def build_tacotron2(cfg: Tacotron2Config, device, dtype: torch.dtype = torch.float32
                    ) -> Tacotron2:
    """The model on ``device`` in ``dtype``, from ``cfg.checkpoint`` (a state
    dict in NVIDIA's schema, ``strict=True``; a ``{"state_dict": ...}``
    wrapper as NVIDIA's ``train.py`` saves is read too) or, without one,
    from seeded random weights (:func:`seeded_weights`)."""
    with torch.device(device):
        model = Tacotron2(cfg)
    if cfg.checkpoint:
        state = torch.load(cfg.checkpoint, map_location=device, weights_only=True)
        model.load_state_dict(state.get("state_dict", state), strict=True)
    else:
        model.load_state_dict(seeded_weights(model, cfg.weights_seed), strict=True)
    return model.to(dtype).eval()


def seeded_weights(model: nn.Module, seed: int) -> dict:
    """A state dict for ``model`` from ``seed``: a weight of fan-in f
    N(0, 2/f), a bias N(0, 0.1²), a BatchNorm's gain and running variance
    1 + N(0, 0.1²), its running mean N(0, 0.1²), its counter 0."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            out[name] = torch.zeros_like(t)
            continue
        x = torch.randn(t.shape, generator=gen)
        if name.endswith(("bias", "running_mean")):
            x = 0.1 * x
        elif t.dim() == 1:
            x = 1.0 + 0.1 * x
        else:
            x = x * (2.0 / t[0].numel()) ** 0.5
        out[name] = x
    return out
