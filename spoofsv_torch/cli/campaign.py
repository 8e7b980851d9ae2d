"""``python -m spoofsv_torch.cli.campaign``: the realistic-scale attack campaign.

Port of ``scripts/campaign.py``: train the whole stack well past toy scale
and run the reference's tri-system evaluation, every stage through the
port's own entry points (on the card unless :func:`main` is given
``device="cpu"``):

  corpus       rich toy corpus + TTS texts + fake ASVspoof-LA sides
               (bonafide = extra disjoint speakers; CM train spoofs =
               Griffin-Lim copy-synthesis, one batched GL64 in f32)
  prepare      metagen splits + warm feature cache
  train_t2m    ordinary Text2Mel          (cli.main train_text2mel)
  train_ssrn   ordinary SSRN              (cli.main train_ssrn)
  train_adv    WGAN-GP Text2Mel           (cli.main --adversarial)
  synthesize   held-out-split synthesis losses (cli.main synthesize --mcd)
  spoofgen     spoof set + tri-system staging (cli.generate_test_utterances)
  ge2e         GE2E train + staged-nospoof evaluation → EER/FRR/spoof rate
  ivector      i-vector/PLDA pipeline (cached models) → EER/spoof rate
  ivector_ref  one reference-scale (1024 Gauss / 400-dim) run (run.sh:105-129)
  cm           countermeasure train + dev scoring → CM EER
  curve        SR-vs-FRR curves (cli.curve)
  report       <root>/RESULTS{suffix}.json

and the adversarial chain (``spoofgen_adv`` … ``curve_adv``): spoofs from the
WGAN-GP Text2Mel scored by the same trained verifiers and countermeasure.

The flags, their defaults, the tree under ``--root``, the resumable
``state/<stage>.json`` markers (with ``_wall_s``), the stage order and the
report's keys are the JAX script's. ``--split_suffix`` runs a speaker-split
variant that reuses the base campaign's corpus and trained models and
raises when the base stages are missing.

Differences from the JAX script, by design: the trained checkpoints are the
port's ``.tar.pth`` files (:func:`resolve_checkpoint`), and the
copy-synthesis starts from the hash "random" phase init (kernel K2's random
mode, seeded per utterance) instead of jax's PRNG bits; on the card it runs
K2 and the f32 Griffin-Lim kernel (``csrc/gl.cu``), on the CPU their plain
versions. Nothing happens at import: :class:`Campaign` holds the root, the
markers, the suffix and the tags.

Usage:

  python -m spoofsv_torch.cli.campaign [--root <repo>/_campaign] [--speakers 60]
         [--utts 110] [--t2m_steps 40000] [--only stage | --skip stage ...]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE_TAG = "campaign"            # checkpoints (TTS, CM) always come from the
BASE_TAG_ADV = "campaign_adv"    # base campaign's training stages

# the stages in the order the campaign runs them and the report lists them
BASE_STAGES = ("corpus", "prepare", "train_t2m", "train_ssrn", "train_adv", "synthesize")
ATTACK_STAGES = ("spoofgen", "ge2e", "ivector", "ivector_ref", "cm", "curve",
                 "spoofgen_adv", "ge2e_adv", "ivector_adv", "cm_adv", "curve_adv")
REPORT_STAGES = BASE_STAGES + ATTACK_STAGES
# stages that depend on the train/test speaker split: their state markers,
# output dirs and result files are suffixed in --split_suffix mode. Training
# stages (corpus/prepare/train_*/synthesize) are split-independent and always
# come from the base campaign.
SPLIT_STAGES = {"spoofgen", "ge2e", "ivector", "cm", "curve", "spoofgen_adv",
                "ge2e_adv", "ivector_adv", "cm_adv", "curve_adv", "report"}
# what --split_suffix needs the base campaign to have done
SPLIT_NEEDS = ("corpus", "train_t2m", "train_ssrn", "train_adv", "synthesize", "cm")
# the stages whose results the report prints
PRINTED = ("ge2e", "ivector", "ivector_ref", "cm", "synthesize", "ge2e_adv", "ivector_adv",
           "cm_adv")

# the fake ASVspoof2019-LA sides: 10 extra speakers, 30 bona fide and 20
# copy-synthesised utterances each
LA_SPEAKERS, LA_BONA, LA_COPY = 10, 30, 20
COPY_GL_ITERS = 64


def build_parser() -> argparse.ArgumentParser:
    ps = argparse.ArgumentParser(description="realistic-scale quality campaign (PyTorch/CUDA)")
    ps.add_argument("--root", default=os.path.join(REPO, "_campaign"))
    ps.add_argument("--speakers", type=int, default=60)
    ps.add_argument("--utts", type=int, default=110)
    ps.add_argument("--train_spk", type=int, default=40)
    ps.add_argument("--enroll", type=int, default=3)
    ps.add_argument("--eval_num", type=int, default=20)
    ps.add_argument("--batch_size", type=int, default=64)
    ps.add_argument("--t2m_steps", type=int, default=40000)
    ps.add_argument("--ssrn_steps", type=int, default=30000)
    ps.add_argument("--adv_steps", type=int, default=20000)
    ps.add_argument("--ge2e_epochs", type=int, default=600)
    ps.add_argument("--ge2e_n", type=int, default=6)
    ps.add_argument("--ge2e_m", type=int, default=50)
    ps.add_argument("--ge2e_hidden", type=int, default=768)
    ps.add_argument("--ge2e_layers", type=int, default=3)
    ps.add_argument("--ge2e_proj", type=int, default=256)
    ps.add_argument("--ivec_gauss", type=int, default=256)
    ps.add_argument("--ivec_dim", type=int, default=100)
    ps.add_argument("--cm_cap", type=int, default=3500)
    ps.add_argument("--cm_steps", type=int, default=4000)
    ps.add_argument("--speaker_batch", type=int, default=20)
    ps.add_argument("--metrics_every", type=int, default=50)
    ps.add_argument("--hidden_dim", type=int, default=256)
    ps.add_argument("--val_every_iter", type=int, default=2000)
    ps.add_argument("--only", type=str, default=None)
    ps.add_argument("--skip", action="append", default=[])
    ps.add_argument("--force", action="append", default=[],
                    help="re-run these stages even if their marker exists")
    ps.add_argument("--split_suffix", type=str, default="",
                    help="run a speaker-split variant (the reference's "
                         "S1/S2/S3 --train_spk_num schemes, "
                         "generate_test_utterances.py:47) reusing the base "
                         "campaign's corpus + trained TTS/CM models: only the "
                         "staging + verification stages re-run, with stage "
                         "markers/dirs suffixed (e.g. --split_suffix _s50 "
                         "--train_spk 50)")
    return ps


def resolve_checkpoint(root: str, tag: str, prefix: str, adversarial: bool = False) -> str:
    """The trained ``{prefix}`` (``text2mel`` or ``ssrn``) of run ``tag``:
    ``{prefix}_best_model.tar.pth`` under
    ``<root>/checkpoints/conditional/{adversarial|not_adversarial}/<tag>/``,
    else the highest ``{prefix}_iteration_N.tar.pth`` there. Raises
    ``FileNotFoundError`` when the run wrote neither."""
    from spoofsv_torch.train.loop import latest_checkpoint

    base = os.path.join(root, "checkpoints", "conditional",
                        "adversarial" if adversarial else "not_adversarial", tag)
    best = os.path.join(base, f"{prefix}_best_model.tar.pth")
    if os.path.isfile(best):
        return os.path.abspath(best)
    path = latest_checkpoint(base, prefix) if os.path.isdir(base) else None
    if path is None:
        raise FileNotFoundError(f"no {prefix} checkpoint under {base}")
    return path


def copy_synthesize(waves: Sequence[np.ndarray], cfg, device,
                    init_angles=None) -> List[np.ndarray]:
    """Griffin-Lim copy-synthesis of ``waves`` (the LA train spoofs): each
    wave's pre-emphasised |STFT| into one zero-padded batch, one f32 GL of
    :data:`COPY_GL_ITERS` iterations, de-emphasis, each cut to its wave's
    length and peak-normalised to 0.75. The phases start from
    ``init_angles`` ((cos, sin) of the batch's shape) when given, else from
    the hash "random" init with per-utterance seeds drawn from
    ``torch.Generator().manual_seed(0)``. On the card: K2's random mode and
    the f32 GL kernel (``csrc/gl.cu``); on the CPU their plain versions."""
    import torch

    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.infer.synthesize import gl_seeds
    from spoofsv_torch.ops import gl_kernel

    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length
    mags = [dsp_host.stft_mag(dsp_host.preemphasis(y, cfg.preemph), n_fft, hop).T
            for y in waves]                                    # (T, bins) each
    batch = np.zeros((len(mags), max(m.shape[0] for m in mags), n_fft // 2 + 1), np.float32)
    for i, m in enumerate(mags):
        batch[i, : m.shape[0]] = m
    mag = torch.from_numpy(batch).to(device)
    if init_angles is None:
        seeds = gl_seeds(len(mags), torch.Generator().manual_seed(0))
        init_angles = gl_kernel.gl_init_angles(mag, n_fft, hop, "random", seeds)
    else:
        init_angles = tuple(torch.as_tensor(a).to(device) for a in init_angles)
    audio = gl_kernel.griffin_lim_fused(mag, n_fft, hop, n_iter=COPY_GL_ITERS,
                                        init_angles=init_angles)
    audio = torchdsp.deemphasis(audio, cfg.preemph).cpu().numpy()
    out = []
    for k, y in enumerate(waves):
        w = audio[k][: len(y)]
        out.append(0.75 * w / max(1e-6, np.abs(w).max()))
    return out


def _cm_result(scores_path: str) -> dict:
    from spoofsv_torch.spoofkit.antispoof import cm_eer

    labels, scores = [], []
    with open(scores_path) as f:
        for line in f:
            parts = line.split()
            labels.append(1.0 if parts[2] == "bonafide" else 0.0)
            scores.append(float(parts[3]))
    labels, scores = np.asarray(labels), np.asarray(scores)
    eer, thr = cm_eer(labels, scores)
    return {"cm_eer": float(eer), "threshold": float(thr),
            "n_bonafide": int(labels.sum()), "n_spoof": int((1 - labels).sum()),
            "scores": scores_path}


class _Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        self.out.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


class Campaign:
    """One campaign run: the parsed flags, the device, the root and its
    paths, the split suffix and the tags. :meth:`run` runs the stages in
    order; each stage is a method ``stage_<name>``."""

    def __init__(self, args: argparse.Namespace, device):
        self.args = args
        self.device = device
        self.root = args.root
        self.state = os.path.join(self.root, "state")
        self.suffix = args.split_suffix
        self.tag = BASE_TAG + self.suffix
        self.tag_adv = BASE_TAG + self.suffix + "_adv"
        self.data_root = os.path.join(self.root, "corpus")
        self.spk_emb = os.path.join(self.root, "spk_emb")
        self.antispoof = os.path.join(self.root, "antispoof") + "/"
        self.texts = os.path.join(self.root, "texts.txt")
        self.cfg_path = os.path.join(self.root, "config.json")

    # -- stage bookkeeping --------------------------------------------------
    def marker(self, name: str) -> str:
        mname = name + self.suffix if (self.suffix and name in SPLIT_STAGES) else name
        return os.path.join(self.state, f"{mname}.json")

    def run_stage(self, name: str, fn: Callable[[], Optional[dict]]) -> dict:
        """Run stage ``name`` unless ``--only``/``--skip`` leave it out or its
        marker exists (and ``--force`` does not name it); returns its marker's
        contents (``{}`` for a left-out stage that never ran)."""
        marker = self.marker(name)
        mname = os.path.basename(marker)[:-5]
        args = self.args
        if args.only and name != args.only:
            print(f"[campaign] {mname}: skipped (--only {args.only})", flush=True)
            return self._read(marker)
        if name in args.skip:
            print(f"[campaign] {mname}: skipped (--skip)", flush=True)
            return self._read(marker)
        if os.path.exists(marker) and name not in args.force:
            print(f"[campaign] {mname}: already done", flush=True)
            return self._read(marker)
        print(f"[campaign] {mname}: start", flush=True)
        t0 = time.time()
        out = fn() or {}
        out["_wall_s"] = round(time.time() - t0, 1)
        with open(marker, "w") as f:
            json.dump(out, f, indent=2, default=float)
        print(f"[campaign] {mname}: done in {out['_wall_s']}s", flush=True)
        return out

    @staticmethod
    def _read(marker: str) -> dict:
        if not os.path.exists(marker):
            return {}
        with open(marker) as f:
            return json.load(f)

    def run(self) -> Dict[str, dict]:
        """Every stage in the JAX script's order; returns each stage's result."""
        os.makedirs(self.state, exist_ok=True)
        out = {}
        if self.suffix:
            # split-scheme variant: the base campaign must have trained everything
            for req in SPLIT_NEEDS:
                if not os.path.exists(os.path.join(self.state, f"{req}.json")):
                    raise RuntimeError(f"--split_suffix needs the base campaign stage "
                                       f"'{req}' done")
        else:
            for name in BASE_STAGES:
                out[name] = self.run_stage(name, getattr(self, f"stage_{name}"))
        for name in (*ATTACK_STAGES, "report"):
            out[name] = self.run_stage(name, getattr(self, f"stage_{name}"))
        return out

    def config(self):
        from spoofsv_torch.config import load_config

        return load_config(self.cfg_path)

    # -- corpus -------------------------------------------------------------
    def stage_corpus(self) -> dict:
        from spoofsv_torch.config import Config
        from spoofsv_torch.data.toy import generate_toy_corpus, random_sentence, synth_sentence
        from spoofsv_torch.data.vctk import prepare_vctk
        from spoofsv_torch.dsp import host as dsp_host

        args = self.args
        speakers = generate_toy_corpus(
            self.data_root, self.spk_emb, n_speakers=args.speakers, utts_per_spk=args.utts,
            seed=0, rich_speakers=True, min_chars=18, max_chars=36, verbose=False)

        rng = np.random.default_rng(777)
        with open(self.texts, "w") as f:
            for _ in range(args.eval_num):
                f.write(random_sentence(rng, 18, 36) + "\n")

        cfg = Config().replace(
            data_root_dir=self.data_root, spk_emb_dir=self.spk_emb,
            src_root_dir=self.root + "/", antispoof_dir=self.antispoof, tts_texts=self.texts,
            hidden_dim=args.hidden_dim, batch_size=args.batch_size,
            val_every_iter=args.val_every_iter)
        prepare_vctk(cfg, verbose=False)
        with open(self.cfg_path, "w") as f:
            json.dump(cfg.to_reference_dict(), f, indent=2)

        # ---- fake ASVspoof2019-LA sides from 10 extra (disjoint) speakers ----
        # dev bonafide: utts 1..30 per speaker; train spoof: Griffin-Lim
        # copy-synthesis of utts 31..50 (vocoder-artifact spoof class, like the
        # LA train attacks the reference CM trains against)
        sr = 22050
        brng = np.random.default_rng(4242)
        dev_flac = os.path.join(self.antispoof, "ASVspoof2019_LA_dev", "flac")
        trn_flac = os.path.join(self.antispoof, "ASVspoof2019_LA_train", "flac")
        proto = os.path.join(self.antispoof, "ASVspoof2019_LA_cm_protocols")
        for d in (dev_flac, trn_flac, proto):
            os.makedirs(d, exist_ok=True)

        bona, to_copy_synth = [], []
        for s in range(LA_SPEAKERS):
            scale = float(0.8 + 0.55 * brng.random())
            h = brng.uniform(0.08, 1.0, 6)
            h = (h / h.sum()).tolist()
            for j in range(LA_BONA + LA_COPY):
                text = random_sentence(brng, 18, 36)
                y = synth_sentence(text, sr, scale, brng, harmonics=h)
                (bona if j < LA_BONA else to_copy_synth).append((f"B{s:02d}", j, y))

        with open(os.path.join(proto, "ASVspoof2019.LA.cm.dev.trl.txt"), "w") as f:
            for k, (spk, j, y) in enumerate(bona):
                name = f"LA_D_BONA{k:04d}"
                dsp_host.write_flac(os.path.join(dev_flac, name + ".flac"),
                                    dsp_host.resample(y, sr, 16000), 16000)
                f.write(f"{spk} {name} - - bonafide\n")

        # copy-synthesis in one fixed-shape batched Griffin-Lim call
        waves = copy_synthesize([y for _, _, y in to_copy_synth], cfg, self.device)
        with open(os.path.join(proto, "ASVspoof2019.LA.cm.train.trn.txt"), "w") as f:
            for k, (spk, j, _) in enumerate(to_copy_synth):
                name = f"LA_T_COPY{k:04d}"
                dsp_host.write_flac(os.path.join(trn_flac, name + ".flac"),
                                    dsp_host.resample(waves[k], sr, 16000), 16000)
                f.write(f"{spk} {name} - - spoof\n")
        return {"speakers": speakers[:3] + ["..."], "n_speakers": args.speakers,
                "utts_per_spk": args.utts, "bona": len(bona),
                "cm_train_spoof": len(to_copy_synth)}

    # -- prepare: warm the feature cache -------------------------------------
    def stage_prepare(self) -> dict:
        from spoofsv_torch.data.pipeline import TTSDataSource

        cfg = self.config()
        spec_dir = os.path.join(self.root, "spec")
        os.makedirs(spec_dir, exist_ok=True)
        counts = {}
        for mode in ("train", "validate", "synthesize"):
            src = TTSDataSource(cfg, mode, spec_dir, need_lin=True)
            src.warm_cache(workers=16)
            counts[mode] = len(src.wav_paths)
        return counts

    # -- training via the CLI surface ---------------------------------------
    def _train(self, step: str, tag: str, steps: int, adversarial: bool) -> dict:
        from spoofsv_torch.cli import main as cli_main

        argv = [step, "-C", self.cfg_path, "-T", tag, "--save_spectrogram",
                "--masked_loss", "--max_iterations", str(steps),
                "--metrics_every", str(self.args.metrics_every), "-R", "latest"]
        if adversarial:
            argv.append("--adversarial")
        cli_main.main(argv, device=self.device)
        return {"steps": steps, "tag": tag, "adversarial": adversarial}

    def stage_train_t2m(self) -> dict:
        return self._train("train_text2mel", self.tag, self.args.t2m_steps, False)

    def stage_train_ssrn(self) -> dict:
        return self._train("train_ssrn", self.tag, self.args.ssrn_steps, False)

    def stage_train_adv(self) -> dict:
        return self._train("train_text2mel", self.tag_adv, self.args.adv_steps, True)

    def _ckpt(self, tag: str, prefix: str, adversarial: bool = False) -> str:
        return resolve_checkpoint(self.root, tag, prefix, adversarial)

    def _write_config(self, path: str, t2m: str, ssrn: str) -> None:
        """``config.json`` with ``INFERENCE_TEXT2MEL_MODEL`` / ``INFERENCE_SSRN_MODEL`` set."""
        with open(self.cfg_path) as f:
            d = json.load(f)
        d["INFERENCE_TEXT2MEL_MODEL"] = t2m
        d["INFERENCE_SSRN_MODEL"] = ssrn
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    def stage_synthesize(self) -> dict:
        from spoofsv_torch.cli import main as cli_main

        self._write_config(self.cfg_path, self._ckpt(BASE_TAG, "text2mel"),
                           self._ckpt(BASE_TAG, "ssrn"))
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            cli_main.main(["synthesize", "-C", self.cfg_path, "-T", self.tag, "--mcd"],
                          device=self.device)
        t2m_losses, ssrn_losses, mcds = [], [], []
        for line in tee.buf.getvalue().splitlines():
            if line.startswith("syn set text2mel loss:"):
                t2m_losses.append(float(line.split()[-1]))
            elif line.startswith("syn set ssrn loss:"):
                ssrn_losses.append(float(line.split()[-1]))
            elif line.startswith("syn set mcd:"):
                mcds.append(float(line.split()[-2]))
        return {"n_batches": len(t2m_losses),
                "text2mel_loss": float(np.mean(t2m_losses)) if t2m_losses else None,
                "ssrn_loss": float(np.mean(ssrn_losses)) if ssrn_losses else None,
                "mcd_db": float(np.mean(mcds)) if mcds else None}

    # -- spoof sets ---------------------------------------------------------
    def stage_spoofgen(self, tag: Optional[str] = None, cfg_path: Optional[str] = None) -> dict:
        from spoofsv_torch.cli import generate_test_utterances as gtu

        tag = tag or self.tag
        args = self.args
        gtu.main(["-C", cfg_path or self.cfg_path, "-T", tag,
                  "--train_spk_num", str(args.train_spk),
                  "--enroll_utt_num", str(args.enroll),
                  "--eval_utt_num", str(args.eval_num),
                  "--speaker_batch", str(args.speaker_batch)], device=self.device)
        test_root = os.path.join(self.root, "test", tag)
        n = len(glob.glob(os.path.join(test_root, "spoof_data", "*", "*.wav")))
        return {"spoof_wavs": n, "test_root": test_root}

    def stage_spoofgen_adv(self) -> dict:
        """Spoof set from the WGAN-GP Text2Mel (ordinary SSRN: the adversarial
        campaign trains the generator adversarially; SSRN is shared)."""
        cfg_adv = os.path.join(self.root, f"config_adv{self.suffix}.json")
        self._write_config(cfg_adv, self._ckpt(BASE_TAG_ADV, "text2mel", adversarial=True),
                           self._ckpt(BASE_TAG, "ssrn"))
        return self.stage_spoofgen(tag=self.tag_adv, cfg_path=cfg_adv)

    # -- GE2E ---------------------------------------------------------------
    def ge2e_config(self, tag: Optional[str] = None, extra: str = ""):
        from spoofsv_torch.config import GE2EConfig

        args, root = self.args, self.root
        tag = tag or self.tag
        suffix = self.suffix + extra     # split variants keep their own dirs/ckpts
        test_root = os.path.join(root, "test", tag)
        ge2e = GE2EConfig()
        n_test = args.speakers - args.train_spk
        return dataclasses.replace(
            ge2e,
            unprocessed_data=os.path.join(test_root, "ge2e_data", "*", "*.wav"),
            save_simmat_dir=os.path.join(root, "simmat" + suffix),
            data=dataclasses.replace(
                ge2e.data, train_path=os.path.join(root, "tisv_train" + suffix),
                test_path=os.path.join(root, "tisv_test" + suffix)),
            model=dataclasses.replace(ge2e.model, hidden=args.ge2e_hidden,
                                      num_layer=args.ge2e_layers, proj=args.ge2e_proj),
            train=dataclasses.replace(
                ge2e.train, N=args.ge2e_n, M=args.ge2e_m, checkpoint_interval=200,
                checkpoint_dir=os.path.join(root, "ge2e_ck" + self.suffix),
                log_file=os.path.join(root, "ge2e_ck" + self.suffix, "Stats")),
            test=dataclasses.replace(
                ge2e.test, N=n_test, M=2 * (args.enroll + 2 * args.eval_num), epochs=1))

    def _ge2e_evaluate(self, ge2e, tag: str, checkpoint: str) -> dict:
        from spoofsv_torch.spoofkit import ge2e_harness as gh

        args = self.args
        test_root = os.path.join(self.root, "test", tag)
        res = gh.run_ge2e_evaluation(
            ge2e, enroll_num=args.enroll, eval_num=args.eval_num, model_path=checkpoint,
            verbose=True, nospoof_data=os.path.join(test_root, "ivector_data", "test_nospoof",
                                                    "*", "*.wav"),
            seed=0, device=self.device)
        res["checkpoint"] = checkpoint
        return res

    def _ge2e_preprocess(self, ge2e) -> None:
        from spoofsv_torch.spoofkit import ge2e_harness as gh

        args = self.args
        gh.save_spectrogram_tisv(ge2e, train_spk_num=args.train_spk,
                                 enroll_num=args.enroll + args.eval_num,
                                 eval_num=args.eval_num, seed=0, verbose=False)

    def stage_ge2e(self) -> dict:
        from spoofsv_torch.spoofkit import ge2e_harness as gh

        ge2e = self.ge2e_config()
        self._ge2e_preprocess(ge2e)
        gh.train_ge2e(ge2e, max_epochs=self.args.ge2e_epochs, verbose=True, device=self.device)
        ck = sorted(glob.glob(os.path.join(self.root, "ge2e_ck" + self.suffix, "final_*.npz")))
        return self._ge2e_evaluate(ge2e, self.tag, ck[-1])

    def stage_ge2e_adv(self) -> dict:
        """Re-stage the adversarial spoof set through the SAME trained embedder:
        only the spoof crops change, so EER/threshold transfer is apples-to-apples
        with the ordinary chain."""
        ge2e = self.ge2e_config(tag=self.tag_adv, extra="_adv")
        self._ge2e_preprocess(ge2e)
        with open(os.path.join(self.state, f"ge2e{self.suffix}.json")) as f:
            ck = json.load(f)["checkpoint"]
        return self._ge2e_evaluate(ge2e, self.tag_adv, ck)

    # -- i-vector -----------------------------------------------------------
    def _ivector(self, tag: str, **kw) -> dict:
        from spoofsv_torch.spoofkit.ivector import run_ivector_pipeline

        args = self.args
        kw.setdefault("num_gauss", args.ivec_gauss)
        kw.setdefault("ivec_dim", args.ivec_dim)
        kw.setdefault("models_dir", os.path.join(self.root, "ivector_models" + self.suffix))
        return run_ivector_pipeline(self.config(), tag, enroll_num=args.enroll,
                                    eval_num=args.eval_num, workers=8, verbose=True,
                                    device=self.device, **kw)

    def stage_ivector(self) -> dict:
        return self._ivector(self.tag)

    def stage_ivector_adv(self) -> dict:
        """Score the adversarial spoof set with the CACHED i-vector models
        (run.sh [1] semantics: UBM/T/PLDA reused, scoring only)."""
        return self._ivector(self.tag_adv)

    def stage_ivector_ref(self) -> dict:
        """One reference-scale run: 1024 Gaussians / 400-dim i-vectors
        (kaldi_ivectors/run.sh:105-129) on a reduced utterance set."""
        return self._ivector(self.tag, num_gauss=1024, ivec_dim=400, max_train_utts_per_spk=20,
                             ubm_frames_cap=400_000,
                             models_dir=os.path.join(self.root, "ivector_models_ref"))

    # -- countermeasure -----------------------------------------------------
    def _cm_cli(self, argvs: List[List[str]]) -> None:
        """The CM CLI's steps from the root (it writes ./checkpoints and
        ./cm_scores under the working directory)."""
        from spoofsv_torch.cli import antispoof as cm_cli

        cwd = os.getcwd()
        os.chdir(self.root)
        try:
            for argv in argvs:
                cm_cli.main(argv, device=self.device)
        finally:
            os.chdir(cwd)

    def _score_cm(self, tag: str, train: bool = False) -> dict:
        args = self.args
        ck = os.path.join(self.root, "checkpoints", BASE_TAG, "final.npz")
        steps = [["dev", "-C", self.cfg_path, "-T", tag, "-R", ck,
                  "--bonafide_cap", str(args.cm_cap)]]
        if train:
            steps.insert(0, ["train", "-C", self.cfg_path, "-T", tag,
                             "--bonafide_cap", str(args.cm_cap),
                             "--max_iterations", str(args.cm_steps), "--save_interval", "2000"])
        self._cm_cli(steps)
        return _cm_result(os.path.join(self.root, "cm_scores", f"scores_{tag}.txt"))

    def stage_cm(self) -> dict:
        # a split variant reuses the base campaign's classifier (the CM train
        # set, the LA-train analog, is split-independent) and only scores
        # this split's dev protocol
        return self._score_cm(self.tag, train=not self.suffix)

    def stage_cm_adv(self) -> dict:
        """Score the adversarial spoof set with the SAME trained countermeasure."""
        return self._score_cm(self.tag_adv)

    # -- curves and report --------------------------------------------------
    def _curve(self, tag: str, suffix: str, out_name: str) -> dict:
        from spoofsv_torch.cli import curve as curve_cli
        from spoofsv_torch.spoofkit.curve import points_path

        args = self.args
        test_root = os.path.join(self.root, "test", tag)
        simmats = sorted(glob.glob(os.path.join(self.root, "simmat" + suffix, "*.npy")))
        out = os.path.join(self.root, out_name)
        png = curve_cli.main(["--simmat", simmats[0],
                              "--ivector_score", os.path.join(test_root, "ivector_data",
                                                              "scores", "plda_scores_mixed.txt"),
                              "--n_speakers", str(args.speakers - args.train_spk),
                              "--eval_num", str(args.eval_num), "--out", out])
        # the PNG is None where matplotlib is not installed; the points are always written
        return {"curve": png, "points": points_path(out)}

    def stage_curve(self) -> dict:
        return self._curve(self.tag, self.suffix, f"curve{self.suffix}.png")

    def stage_curve_adv(self) -> dict:
        return self._curve(self.tag_adv, self.suffix + "_adv", f"curve{self.suffix}_adv.png")

    def stage_report(self) -> dict:
        out = {}
        for name in REPORT_STAGES:
            marker = self.marker(name)
            if os.path.exists(marker):
                out[name] = self._read(marker)
        results = os.path.join(self.root, f"RESULTS{self.suffix}.json")
        with open(results, "w") as f:
            json.dump(out, f, indent=2, default=float)
        print(json.dumps({k: v for k, v in out.items() if k in PRINTED}, indent=2,
                         default=float))
        return {"results": results}


def main(argv=None, device=None) -> Dict[str, dict]:
    """Parse ``argv`` and run the campaign on ``device`` (the card unless
    ``device="cpu"``). Returns each stage's result (its marker's contents)."""
    from spoofsv_torch import reference_precision, resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if device.type == "cuda":
        reference_precision()   # f32 means f32: no TF32 convs or matmuls
    return Campaign(args, device).run()


if __name__ == "__main__":
    main()
