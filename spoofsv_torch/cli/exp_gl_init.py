"""``python -m spoofsv_torch.cli.exp_gl_init``: the Griffin-Lim init experiment.

Port of ``scripts/exp_gl_init.py``: can the SPSI instantaneous-frequency
init reach the reference's spectral convergence in fewer iterations? At
B=6, T=400 over the three synthetic distributions of
:func:`spoofsv_torch.cli.checklib.mag_distributions` and a real-audio one
(toy-corpus sentences through the vocoder's feature chain: pre-emphasis →
|STFT| → max-norm → power 1.3, the non-log GL input), the spectral
convergence (FFT STFT) of the f32 Griffin-Lim from the advance init and from
SPSI with phase locking 1, 0 and −1 after 0-32 iterations, and from the
"random" init after 64 (the reference's call).

The JAX script pins the CPU; this one follows the port's rule: the card
unless :func:`main` is given ``device="cpu"``. There each init is kernel K2
(``csrc/gl.cu::gl_init_kernel``, every mode and lock) and the iterations the
f32 Griffin-Lim of ``csrc/gl.cu``, down to 0 iterations (the init followed
by the synthesis epilogue); CPU tensors take their plain versions. The
"random" init is the hash init seeded from
``torch.Generator().manual_seed(0)``, not jax's PRNG. The result goes to
``exp_gl_init.json`` in the temporary directory (``/tmp`` unless
``TMPDIR`` names another), as the JAX script writes ``/tmp/exp_gl_init.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from spoofsv_torch.cli import checklib

N_FFT, HOP = 1024, 256
INITS = ["advance", "spsi:1", "spsi:0", "spsi:-1"]
ITERS = [0, 4, 8, 12, 16, 24, 32]


def real_audio_mags(B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    from spoofsv_torch.data.toy import random_sentence, synth_sentence
    from spoofsv_torch.dsp import torchdsp

    sr = 22050
    n_samp = (T - 1) * HOP
    mags = []
    for b in range(B):
        text = random_sentence(rng, min_chars=60, max_chars=80)
        h = [0.5 / (k + 1) * float(rng.uniform(0.5, 1.5)) for k in range(6)]
        y = synth_sentence(text, sr, 1.0 + 0.1 * b, rng, harmonics=h)
        while len(y) < n_samp + 1:
            y = np.concatenate([y, y])
        y = y[: n_samp + 1].astype(np.float32)
        y = np.append(y[0], y[1:] - 0.97 * y[:-1])  # preemphasis
        re, im = torchdsp.stft_ri(torch.from_numpy(y)[None], N_FFT, HOP)
        m = torch.sqrt(re * re + im * im).numpy()[0]
        m = m / max(m.max(), 1e-8)
        mags.append(m[:T] ** 1.3)
    return np.stack(mags)


def init_angles(mag: torch.Tensor, init: str):
    """K2's angles for ``init``: "random" (hash, seeds from
    ``torch.Generator().manual_seed(0)``), "advance" or "spsi[:lock]"."""
    from spoofsv_torch.infer.synthesize import gl_seeds
    from spoofsv_torch.ops import gl_kernel

    if init == "random":
        seeds = gl_seeds(mag.shape[0], torch.Generator().manual_seed(0)).to(mag.device)
        return gl_kernel.gl_init_angles(mag, N_FFT, HOP, "random", seeds)
    if init == "advance":
        return gl_kernel.gl_init_angles(mag, N_FFT, HOP, "advance")
    lock = float(init.split(":")[1]) if ":" in init else 1.0
    return gl_kernel.gl_init_angles(mag, N_FFT, HOP, "spsi", lock=lock)


def run_gl(mag: torch.Tensor, n_iter: int, init: str) -> float:
    """Spectral convergence of ``n_iter`` f32 GL iterations from ``init``."""
    from spoofsv_torch.ops import gl_kernel

    audio = gl_kernel.griffin_lim_fused(mag, N_FFT, HOP, N_FFT, n_iter=n_iter,
                                        init_angles=init_angles(mag, init))
    return checklib.spectral_convergence(audio, mag, N_FFT, HOP)


def main(argv=None, device=None) -> dict:
    """Run the experiment on ``device`` (the card unless ``device="cpu"``);
    returns distribution -> "init@iters" -> spectral convergence."""
    argparse.ArgumentParser(description="Griffin-Lim init experiment").parse_args(argv)
    device = checklib.check_device(device)
    rng = np.random.default_rng(0)
    B, T, F = 6, 400, 513
    dists = checklib.mag_distributions(B, T, F, rng)
    dists["real_audio"] = real_audio_mags(B, T, np.random.default_rng(1))

    out = {}
    for dname, mag_np in dists.items():
        mag = torch.from_numpy(np.ascontiguousarray(mag_np, np.float32)).to(device)
        out[dname] = {}
        # reference: random-64 (the reference's librosa call)
        out[dname]["random@64"] = run_gl(mag, 64, "random")
        for init in INITS:
            for it in ITERS:
                out[dname][f"{init}@{it}"] = run_gl(mag, it, init)
        print(dname, json.dumps(out[dname], indent=1), flush=True)
    path = os.path.join(tempfile.gettempdir(), "exp_gl_init.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
