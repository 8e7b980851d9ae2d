"""The comparisons that decide ``correct`` for synthesis.

Each function takes what the program's timed path produced for one call
(stage by stage), works the same stage out again with the plain reference
from the same inputs, and returns the readings: the widest gaps and the
relative distances named in the cell's limits. :func:`control_readings`
puts the reference, computed in the precision below the configuration's,
in the program's place over the same inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import dctts, vocoder

ROWS = 32   # utterances a block of the reference


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def decode_readings(sd: dict, ids, spk, mel, att, p=dctts.F32, ref=None) -> Dict[str, float]:
    """The rollout's mel and attention against the model worked out again at
    each frame from the rollout's own past (teacher forced): the widest gaps."""
    mel_gap = att_gap = 0.0
    for i in range(0, mel.shape[0], ROWS):
        sl = slice(i, i + ROWS)
        y, a = dctts.decode_teacher_forced(sd, ids[sl], spk[sl], mel[sl], att[sl], p)
        if ref is None:
            y_c, a_c = mel[sl].float(), att[sl].float()
        else:   # a control: the reference at lower precision in the program's place
            y_c, a_c = y, a
            y, a = dctts.decode_teacher_forced(sd, ids[sl], spk[sl], mel[sl], att[sl], ref)
        mel_gap = max(mel_gap, float((y - y_c).abs().max()))
        att_gap = max(att_gap, float((a - a_c).abs().max()))
    return {"decode_mel_gap": mel_gap, "decode_att_gap": att_gap}


def ssrn_readings(sd: dict, mel, lin, p=dctts.F32, ref=None) -> Dict[str, float]:
    """SSRN's linear magnitude against the reference's on the same mel."""
    num = den = 0.0
    gap = 0.0
    for i in range(0, mel.shape[0], ROWS):
        sl = slice(i, i + ROWS)
        want = dctts.ssrn(sd, mel[sl], dctts.F32 if ref is None else ref)
        got = lin[sl].float() if ref is None else dctts.ssrn(sd, mel[sl], p)
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
        gap = max(gap, float((got - want).abs().max()))
    return {"ssrn_rel": (num / max(den, 1e-30)) ** 0.5, "ssrn_gap": gap}


def spectral_convergence(audio: np.ndarray, spec: torch.Tensor, voc: dict) -> np.ndarray:
    """Per row, ‖|STFT(x)| − S‖ / ‖S‖ with x the audio before de-emphasis
    (pre-emphasis undoes it exactly) and S the magnitude the vocoder was
    asked for."""
    c = voc["preemph"]
    x = np.asarray(audio, np.float64)
    x = x - c * np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    re, im = vocoder.stft(torch.from_numpy(x).float().to(spec.device), voc["n_fft"], voc["hop"])
    got = torch.sqrt(re * re + im * im)[:, :spec.shape[1]]
    return (torch.linalg.vector_norm(got - spec, dim=(1, 2))
            / torch.linalg.vector_norm(spec, dim=(1, 2))).cpu().numpy()


def target_spec(lin: torch.Tensor, voc: dict) -> torch.Tensor:
    x = lin.float()
    x = x / x.amax(dim=(1, 2), keepdim=True).clamp_min(1e-8)
    return torch.pow(x, voc["power"])


def vocoder_readings(lin, audio: np.ndarray, voc: dict, seeds: Optional[torch.Tensor],
                     r=vocoder.EXACT, ref=None) -> Dict[str, float]:
    """The vocoder's audio against the reference vocoder's on the same
    linear magnitude: the relative distance of the waveforms, and the gap
    between their spectral convergences (row by row, the widest)."""
    want = vocoder.vocode(lin, voc, seeds, vocoder.EXACT if ref is None else ref)
    got = np.asarray(audio, np.float64) if ref is None else vocoder.vocode(lin, voc, seeds, r)
    sc_gap = 0.0
    for i in range(0, lin.shape[0], ROWS):
        spec = target_spec(lin[i: i + ROWS], voc)
        d = np.abs(spectral_convergence(got[i: i + ROWS], spec, voc)
                   - spectral_convergence(want[i: i + ROWS], spec, voc))
        sc_gap = max(sc_gap, float(d.max()))
    return {"vocoder_rel": _rel(got, want), "vocoder_sc_gap": sc_gap}


def synthesis_readings(sd_t2m: dict, sd_ssrn: dict, voc: dict, call: dict) -> Dict[str, float]:
    """Every stage of one synthesis call: ``call`` holds the inputs (``ids``,
    ``spk``, ``seeds``) and what the program produced (``mel``, ``att``,
    ``lin`` on the device, ``audio`` on the host)."""
    out = decode_readings(sd_t2m, call["ids"], call["spk"], call["mel"], call["att"])
    out.update(ssrn_readings(sd_ssrn, call["mel"], call["lin"]))
    out.update(vocoder_readings(call["lin"], call["audio"], voc, call["seeds"]))
    return out


def control_readings(sd_t2m: dict, sd_ssrn: dict, voc: dict, call: dict,
                     model_precision: str, vocoder_rounding: str) -> Dict[str, float]:
    """The readings of the reference in the precision below the
    configuration's (``model_precision`` for Text2Mel and SSRN,
    ``vocoder_rounding`` for the vocoder's transforms) in the program's
    place, on the program's own inputs to each stage."""
    p = dctts.Precision(model_precision)
    out = decode_readings(sd_t2m, call["ids"], call["spk"], call["mel"], call["att"], p,
                          ref=dctts.F32)
    out.update(ssrn_readings(sd_ssrn, call["mel"], call["lin"], p, ref=dctts.F32))
    out.update(vocoder_readings(call["lin"], call["audio"], voc, call["seeds"],
                                vocoder.Rounding(vocoder_rounding), ref=vocoder.EXACT))
    return out
