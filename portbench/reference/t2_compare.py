"""The comparisons that decide ``correct`` for Tacotron 2 synthesis.

Each function takes what the program's timed path produced for one call,
stage by stage, works the stage out again with the plain reference
(``reference/tacotron2.py``, a byte copy of ``plainref/tacotron2.py``) from
the same inputs, and returns the readings named in the cell's limits.

* The rollout, teacher forced: the reference's own float32 decoder, fed at
  each step the frame the program emitted the step before and the same
  hashed prenet masks, against the program's frames, stop logits and
  attention: the widest gaps. The reference starts each segment between two
  of the program's state checkpoints (every 25 steps) from the program's
  state there, so that it follows the program's state stage by stage: a
  recurrence of 1000 steps at random weights carries rounding along (run
  whole from step 0, a bf16 rollout's mel parted from float32's by 0.25-0.5
  in its last hundred steps against 0.04-0.07 in its first, and its
  attention by up to 0.44; resumed every 100 steps, a sound run's widest
  attention gap still reached 0.032 against the fp8 control's 0.068). The
  widest mel gaps of the first and the last hundred steps are read too, to
  show that the gap does not grow along the rollout.
* The postnet on the program's frames: the relative distance.
* The mel's linear magnitude (``vocode.prep``: exp, the Slaney basis's
  pseudo-inverse, the clamp) on the program's postnet mel: the relative
  distance.
* Griffin-Lim on the program's linear magnitude: ``compare.vocoder_readings``
  with each row scaled to a peak of 1 (program audio alike: Griffin-Lim is
  homogeneous in the magnitude), power 1 and no de-emphasis. (On a magnitude
  of its own, the reference's SPSI picks its peaks otherwise where the two
  magnitudes part by rounding, and the spectral convergences part by up to
  2e-3.)

``control=True`` puts the reference in the precision below the
configuration's (``model`` for the encoder, rollout and postnet, ``prep``
for the pseudo-inverse's product, ``vocoder`` for the transforms) in the
program's place, over the program's inputs to each stage.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import compare, tacotron2 as t2, vocoder

HUNDRED = 100


def vocoder_params(conf: dict) -> dict:
    hp = conf["config"]
    return {"n_fft": hp["filter_length"], "hop": hp["hop_length"], "power": 1.0,
            "init": hp["TPU"]["griffin_lim_init"], "iters": hp["TPU"]["griffin_lim_iters"],
            "preemph": 0.0, "sr": hp["sampling_rate"]}


def _segments(sd: dict, hp: dict, memory, lengths, seeds, frames, states, p: t2.Precision):
    """The reference teacher forced over the program's frames, each segment
    from the program's state at its start: (mel, gate, attention) over all
    the steps."""
    T = frames.shape[1]
    starts = [int(x) for x in states["step"]] + [T]
    outs = []
    for i, (t0, t1) in enumerate(zip(starts[:-1], starts[1:])):
        state = {k: states[k][i] for k in t2.STATE}
        outs.append(t2.rollout(sd, memory, lengths, seeds, t1 - t0, hp, p, frames=frames,
                               start=t0, state=state))
    return tuple(torch.cat(parts, dim=d) for parts, d in zip(zip(*outs), (1, 1, 2)))


def rollout_readings(sd: dict, hp: dict, call: dict, p: t2.Precision = t2.F32,
                     control: bool = False) -> Dict[str, float]:
    """The teacher-forced rollout's gaps over the call's rows."""
    ids, spk, seeds, frames = call["ids"], call["spk"], call["seeds"], call["frames"]
    lengths = t2.lengths_of(ids)
    states = call["states"]
    y, g, a = _segments(sd, hp, t2.encoder(sd, ids, spk, hp), lengths, seeds, frames, states,
                        t2.F32)
    if control:
        y_c, g_c, a_c = _segments(sd, hp, t2.encoder(sd, ids, spk, hp, p), lengths, seeds,
                                  frames, states, p)
    else:
        y_c, g_c, a_c = frames.float(), call["gate"].float(), call["att"].float()
    d = (y - y_c).abs().amax(dim=(0, 2))
    return {"rollout_mel_gap": float(d.max()),
            "rollout_att_gap": float((a - a_c).abs().max()),
            "rollout_gate_gap": float((g - g_c).abs().max()),
            "rollout_mel_gap_first100": float(d[:HUNDRED].max()),
            "rollout_mel_gap_last100": float(d[-HUNDRED:].max())}


def postnet_readings(sd: dict, hp: dict, frames: torch.Tensor, post: torch.Tensor,
                     p: t2.Precision = t2.F32, control: bool = False) -> Dict[str, float]:
    want = t2.postnet(sd, frames, hp)
    got = t2.postnet(sd, frames, hp, p) if control else post.float()
    return {"postnet_rel": float(torch.linalg.norm(got - want) / torch.linalg.norm(want))}


def prep_readings(hp: dict, post: torch.Tensor, spec: torch.Tensor,
                  rounding: Optional[str] = None) -> Dict[str, float]:
    """The program's linear magnitude (or, with ``rounding``, the
    reference's with the product's operands so rounded) against the
    reference's, on the program's postnet mel."""
    want = t2.mel_to_linear(post, hp)
    if rounding is None:
        got = spec.float()
    else:
        inv = torch.from_numpy(np.linalg.pinv(t2.mel_basis(hp)).T.copy()).float().to(post.device)
        r = vocoder.Rounding(rounding)
        got = torch.clamp(r(torch.exp(post.float())) @ r(inv), min=0.0)
    return {"prep_rel": float(torch.linalg.norm(got - want) / torch.linalg.norm(want))}


def vocoder_readings(voc: dict, spec: torch.Tensor, audio: np.ndarray, seeds: torch.Tensor,
                     r: Optional[vocoder.Rounding] = None) -> Dict[str, float]:
    """Griffin-Lim on the program's linear magnitude: the program's audio (or,
    with ``r``, the reference's at that rounding) against the exact
    reference's, each row at a peak magnitude of 1."""
    spec = spec.float()
    peak = spec.amax(dim=(1, 2)).clamp_min(1e-30)
    spec = spec / peak[:, None, None]
    audio = np.asarray(audio, np.float64) / peak.double().cpu().numpy()[:, None]
    if r is None:
        return compare.vocoder_readings(spec, audio, voc, seeds)
    return compare.vocoder_readings(spec, audio, voc, seeds, r, ref=vocoder.EXACT)


def synthesis_readings(sd: dict, hp: dict, voc: dict, call: dict) -> Dict[str, float]:
    """Every stage of one call: ``call`` holds the inputs (``ids``, ``spk``,
    ``seeds``) and what the program produced (``frames``, ``gate``, ``att``,
    its state checkpoints ``states``, ``post``, the linear magnitude ``spec``
    on the device, ``audio`` on the host)."""
    out = rollout_readings(sd, hp, call)
    out.update(postnet_readings(sd, hp, call["frames"], call["post"]))
    out.update(prep_readings(hp, call["post"], call["spec"]))
    out.update(vocoder_readings(voc, call["spec"], call["audio"], call["seeds"]))
    return out


def control_readings(sd: dict, hp: dict, voc: dict, call: dict, control: dict
                     ) -> Dict[str, float]:
    """The same readings with the reference one precision down in the
    program's place (``control``: the configuration's ``model``, ``prep`` and
    ``vocoder`` precisions), on the program's own inputs to each stage."""
    p = t2.Precision(control["model"])
    out = rollout_readings(sd, hp, call, p, control=True)
    out.update(postnet_readings(sd, hp, call["frames"], call["post"], p, control=True))
    out.update(prep_readings(hp, call["post"], call["spec"], control["prep"]))
    out.update(vocoder_readings(voc, call["spec"], call["audio"], call["seeds"],
                                vocoder.Rounding(control["vocoder"])))
    return out
