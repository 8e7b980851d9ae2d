"""CLI entry point: ``python -m spoofsv_torch.cli.main {train_text2mel|train_ssrn|synthesize}``.

Port of :mod:`spoofsv_tpu.cli.main`, the reference ``main.py:8-49`` surface:
the positional step and ``-P/--pattern``, ``-R/--resume`` (a path or
``latest``), ``-C/--configuration``, ``--adversarial``, ``--save_spectrogram``,
``-T/--current_time``, plus the JAX package's ``--stage``, ``--masked_loss``,
``--max_iterations``, ``--mcd``, ``--device_data``, ``--mesh`` and
``--metrics_every``, and ``--trace_dir`` (a ``torch.profiler`` trace of the
run with the program's spans, :mod:`spoofsv_torch.utils.profiling`). The
helpers (compute dtypes, the process-wide runtime knobs, ``build_models``)
are here too.

Everything runs on the card unless :func:`main` is given ``device="cpu"``.
Given a Tacotron 2 configuration (``config.Tacotron2Config``), ``synthesize``
runs :func:`run_synthesize_tacotron2`; training it is not ported.
Training keeps f32 parameters and Adam state; ``train_compute_dtype=
"bfloat16"`` computes the steps under ``torch.autocast`` to bf16, as the JAX
package builds its models with ``dtype=bfloat16`` over f32 parameters (the
port does so on the CPU too, where JAX computes in f32).

Data parallelism (:func:`resolve_mesh`, :func:`data_parallel`): ``--mesh N``
runs N ranks, one process and one device each (``cuda:0..N−1`` over NCCL,
or N gloo processes on the CPU's cores). Outside a process group the
command spawns the other N−1 ranks itself and runs as rank 0; under
``torchrun`` it joins the group the environment names. ``--mesh all`` and
``MULTI_GPU`` mean every visible CUDA device (one device, the CPU
included, runs single-device, as in the JAX package). More ranks than
devices raise, unless ``--mesh_share`` asks for ranks that time-share the
one device given, over gloo: a check of the data-parallel path on one
card, not a speed-up.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import sys
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from spoofsv_torch import reference_precision, resolve_device
from spoofsv_torch.config import Config, Tacotron2Config, load_config
from spoofsv_torch.models import SSRN, Critic1D, LinDisc, MelDisc, MelSyn
from spoofsv_torch.models.layers import set_default_gate_impl
from spoofsv_torch.utils import profiling

TRAIN_STEPS = ("train_text2mel", "train_ssrn")


def inference_dtype(cfg: Config, device) -> torch.dtype:
    """``cfg.tpu.compute_dtype`` (bf16 by default) on a CUDA device, f32
    elsewhere (the JAX package's rule, with the card in the TPU's place)."""
    if torch.device(device).type == "cuda" and cfg.tpu.compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def training_dtype(cfg: Config, device) -> torch.dtype:
    """``cfg.tpu.train_compute_dtype`` (f32 by default) on any device: the
    steps' autocast dtype over f32 parameters. The JAX package takes bf16 on
    a TPU only; the port takes it on the CPU too, so that its tests can."""
    del device
    return torch.bfloat16 if cfg.tpu.train_compute_dtype == "bfloat16" else torch.float32


def apply_runtime_knobs(cfg: Config, infer: bool = False) -> None:
    """Set the process-wide highway implementation: ``cfg.tpu.highway_gate_impl``
    for training, ``cfg.tpu.highway_infer_impl`` with ``infer=True``, which
    is then what :class:`spoofsv_torch.infer.synthesize.Synthesizer`'s text
    encoder and SSRN run. Unlike the JAX package, a CPU run keeps the
    selected name: CPU tensors take the kernels' plain versions anyway."""
    set_default_gate_impl(cfg.tpu.highway_infer_impl if infer else cfg.tpu.highway_gate_impl)


def build_models(cfg: Config, pattern: str = "conditional", dtype: Optional[torch.dtype] = None,
                 device=None) -> Tuple[MelSyn, SSRN, Critic1D, Critic1D]:
    """Text2Mel, SSRN and their critics (``MelDisc``, ``LinDisc``) with the
    configuration's widths (generator dropout 0.05 when ``cfg.apply_dropout``)
    on ``device``: the card unless the caller passes ``device="cpu"``
    (:func:`spoofsv_torch.resolve_device`, which raises without a card)."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    dropout = 0.05 if cfg.apply_dropout else 0.0
    melsyn = MelSyn(cfg.vocab_len, pattern == "conditional", cfg.spk_emb_dim, cfg.text_emb_dim,
                    cfg.mel.freq_bins, cfg.hidden_dim, dropout)
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim, dropout)
    mel_disc = MelDisc(cfg.disc_dim, freq_bins=cfg.mel.freq_bins)
    lin_disc = LinDisc(cfg.disc_dim, lin_bins=cfg.lin_bins)
    return tuple(m.to(device, dtype) for m in (melsyn, ssrn, mel_disc, lin_disc))


def build_tacotron2_synthesizer(cfg: Tacotron2Config, device, mesh=None,
                                n_frames: Optional[int] = None):
    """A :class:`~spoofsv_torch.infer.synthesize.Tacotron2Synthesizer` of the
    configuration's model in the inference dtype on ``device`` (the weights of
    ``cfg.checkpoint``, or seeded random ones from ``cfg.weights_seed``)."""
    from spoofsv_torch.infer.synthesize import Tacotron2Synthesizer
    from spoofsv_torch.models.tacotron2 import build_tacotron2

    device = resolve_device(device)
    if not cfg.checkpoint:
        print(f"[tacotron2] no checkpoint: seeded random weights (weights_seed "
              f"{cfg.weights_seed})")
    model = build_tacotron2(cfg, device, inference_dtype(cfg, device))
    return Tacotron2Synthesizer(cfg, model, n_frames=n_frames, mesh=mesh)


def add_mesh_args(ps: argparse.ArgumentParser, what: str = "data-parallel") -> None:
    ps.add_argument("--mesh", type=str, default=None, metavar="N|all",
                    help=f"{what} over N ranks, one device each ('all': every visible "
                         "CUDA device)")
    ps.add_argument("--mesh_share", action="store_true",
                    help="the --mesh ranks time-share the one device given, over gloo (a "
                         "check of the data-parallel path on one card, not a speed-up)")


def add_trace_arg(ps: argparse.ArgumentParser) -> None:
    ps.add_argument("--trace_dir", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run, with the program's "
                         "spoofsv.* spans, into DIR (a file per rank)")


def resolve_mesh(args, cfg: Config, device) -> int:
    """The rank count a data-parallel request asks for, as the JAX
    ``resolve_mesh`` reads it: ``--mesh N``, ``--mesh all`` or ``MULTI_GPU``
    (every visible CUDA device; the CPU is one device). 1 means
    single-device. A count above the visible devices (for ``--mesh N`` on
    the CPU: its cores) raises ``ValueError``, unless ``args.mesh_share``."""
    from spoofsv_torch.parallel import multihost

    spec = getattr(args, "mesh", None)
    if spec is None and cfg.multi_gpu:
        spec = "all"
    if spec in (None, "1"):
        return 1
    device = torch.device(device)
    if spec == "all":
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    else:
        n = int(spec)
    if n > 1:
        multihost.rank_devices(n, device, share=getattr(args, "mesh_share", False))
    return max(n, 1)


def _cli_rank(mesh, entry: str, argv) -> None:
    """A spawned rank of a ``--mesh`` command: the same CLI, in the group."""
    importlib.import_module(entry).main(list(argv), device=str(mesh.device))


@contextlib.contextmanager
def data_parallel(args, cfg: Config, device, entry: str, argv) -> Iterator[Optional[object]]:
    """The :class:`~spoofsv_torch.parallel.mesh.Mesh` this command runs on,
    or None for single-device. Inside a process group (a spawned rank, or
    ``torchrun``'s environment) it is the group's mesh; otherwise this
    process spawns ranks 1..N−1 of ``python -m <entry>``'s ``main(argv)``
    and runs as rank 0, and the ranks are joined on exit (each logs to
    ``rank<r>.log`` under a fresh temporary directory)."""
    from spoofsv_torch.parallel import multihost
    from spoofsv_torch.parallel.mesh import make_mesh

    n = resolve_mesh(args, cfg, device)
    if n == 1:
        yield None
        return
    share = getattr(args, "mesh_share", False)
    # a bare "cuda" is this rank's card: cuda:LOCAL_RANK
    dev = device if device.type == "cpu" or device.index is not None or share else None
    joined = not torch.distributed.is_initialized()   # torchrun's group, joined here
    if multihost.initialize_distributed(backend="gloo" if share else None, device=dev):
        mesh = make_mesh(n, dev)
        print(f"[mesh] rank {mesh.rank} of {n} on {mesh.device} ({mesh.backend})")
        try:
            yield mesh
        finally:
            if joined:
                torch.distributed.destroy_process_group()
        return
    devices = multihost.rank_devices(n, device, share=share)
    group = multihost.start_group(n, _cli_rank, entry,
                                  list(argv if argv is not None else sys.argv[1:]),
                                  devices=devices, backend="gloo" if share else None)
    print(f"[mesh] data-parallel over {n} ranks ({group.mesh.backend}, devices "
          f"{[str(d) for d in devices]}); ranks 1-{n - 1} log to "
          f"{os.path.dirname(group.logs[0])}")
    ok = False
    try:
        yield group.mesh
        ok = True
    finally:
        group.finish(ok)


def run_training(args, cfg: Config, spec_dir: Optional[str], device, mesh=None):
    """Train Text2Mel or SSRN (adversarially with ``--adversarial``) on the
    configured corpus, data-parallel over ``mesh``'s ranks when given;
    returns the :class:`~spoofsv_torch.train.Trainer`."""
    from spoofsv_torch.data.pipeline import BucketedLoader, DeviceReplayLoader, TTSDataSource
    from spoofsv_torch.train import Trainer

    melsyn, ssrn, mel_disc, lin_disc = build_models(cfg, args.pattern, device=device)
    with_lin = args.step == "train_ssrn"
    gen, disc = (ssrn, lin_disc) if with_lin else (melsyn, mel_disc)
    train_src = TTSDataSource(cfg, "train", spec_dir, need_lin=with_lin, pattern=args.pattern,
                              stage=args.stage)
    val_src = TTSDataSource(cfg, "validate", spec_dir, need_lin=with_lin, pattern=args.pattern,
                            stage=args.stage)
    trainer = Trainer(cfg, gen, args.step, pattern=args.pattern, adversarial=args.adversarial,
                      disc_model=disc if args.adversarial else None, ctime=args.current_time,
                      use_masks=args.masked_loss, metrics_every=args.metrics_every,
                      compute_dtype=training_dtype(cfg, device), mesh=mesh)
    if args.resume:
        path = args.resume
        if path == "latest":
            path = trainer.ckpt.latest()
            if path is None:
                print("no checkpoint to resume from; starting fresh")
        if path:
            trainer.resume(path)
            print(f"Resumed from {path} at iteration {trainer.iteration}")

    if args.device_data == "on" or (args.device_data == "auto" and device.type == "cuda"):
        # the whole bucket-padded training set on the device, batches
        # gathered there; seeded with the resumed epoch so a restored run
        # continues the shuffle sequence instead of replaying a fresh one
        t0 = time.perf_counter()
        loader = DeviceReplayLoader(train_src, cfg.batch_size, with_lin=with_lin, shuffle=True,
                                    seed=trainer.epoch, mesh=mesh, device=device)
        feature_s = time.perf_counter() - t0
        print(f"[data] {len(loader)} training utterances on {device}: {loader.nbytes} bytes "
              f"resident, built in {feature_s:.3f} s")
        trainer.metrics.log({"split": "data", "utterances": len(loader),
                             "device_bytes": loader.nbytes, "feature_s": feature_s})

        def train_loader():
            return loader
    else:
        def train_loader():
            return BucketedLoader(train_src, cfg.batch_size, with_lin=with_lin, shuffle=True,
                                  seed=trainer.epoch)

    def val_loader():
        return BucketedLoader(val_src, 8, with_lin=with_lin, shuffle=False)

    try:
        trainer.fit(train_loader, val_loader, plot=cfg.plot_curve,
                    max_iterations=args.max_iterations)
    finally:
        trainer.close()
    return trainer


def run_synthesize(args, cfg: Config, spec_dir: Optional[str], device, mesh=None) -> str:
    """Synthesize the ``synthesize`` split from the configured checkpoints
    (``synthesize.py:41-147``): ``S{k}_B{i}.wav`` under
    ``<src_root>/samples/<ctime>/``, the losses against the ground truth and,
    with ``--mcd``, the mel-cepstral distortion. Returns the sample directory.
    Over ``mesh``'s ranks the loader's batch is a multiple of the rank count
    (a flush batch is padded up to one and the padding sliced off), and only
    rank 0 writes wavs and figures."""
    from spoofsv_torch.data.pipeline import BucketedLoader, TTSDataSource
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio, gl_seeds
    from spoofsv_torch.train.loop import plot_attention
    from spoofsv_torch.train.losses import binary_divergence, guided_attention_loss, l1_loss
    from spoofsv_torch.train.steps import guided_attention_table
    from spoofsv_torch.weights import load_generator_params

    melsyn, ssrn, _, _ = build_models(cfg, args.pattern, dtype=inference_dtype(cfg, device),
                                      device=device)
    load_generator_params(cfg.inference_text2mel_model, melsyn)
    load_generator_params(cfg.inference_ssrn_model, ssrn)
    n = 1 if mesh is None else mesh.size
    primary = mesh is None or mesh.rank == 0
    sample_dir = os.path.join(cfg.src_root_dir, "samples", args.current_time)
    os.makedirs(sample_dir, exist_ok=True)
    fig_dir = os.path.join(sample_dir, "fig")
    loader = BucketedLoader(TTSDataSource(cfg, "synthesize", spec_dir, need_lin=True),
                            max(8 // n, 1) * n, with_lin=True, shuffle=False)
    seeds = torch.Generator().manual_seed(0)   # GL phase seeds, read by the "random" init only
    gaw = guided_attention_table(cfg)
    synthesizers = {}
    loss_avg_t2m = loss_avg_ssrn = 0.0
    mcd_vals = []
    n_batches = 0
    for i, batch in enumerate(loader):
        t = batch["mel"].shape[1]
        if t not in synthesizers:   # one pipeline per bucket length
            synthesizers[t] = Synthesizer(cfg, melsyn, ssrn, n_frames=t, mesh=mesh)
        syn = synthesizers[t]
        audio, mel, attn = syn(batch["text"], batch["spk"], gl_seeds(len(batch["text"]), seeds))
        mel_gt = torch.from_numpy(batch["mel"]).to(device)
        l1 = float(l1_loss(mel_gt, mel.float()))
        bd = float(binary_divergence(mel_gt, mel.float()))
        att = float(guided_attention_loss(attn.float(), gaw(device)))
        loss_avg_t2m += l1 + bd + att
        lin_pred = syn.ssrn_apply(mel.to(device)).float()
        lin_gt = torch.from_numpy(batch["lin"]).to(device)
        l1s = float(l1_loss(lin_gt, lin_pred))
        bds = float(binary_divergence(lin_gt, lin_pred))
        loss_avg_ssrn += l1s + bds
        n_batches += 1
        print(f"syn set text2mel loss: {l1} {bd} {att} {l1 + bd + att}")
        print(f"syn set ssrn loss: {l1s} {bds} {l1s + bds}")
        if args.mcd:
            from spoofsv_torch.spoofkit.mcd import batch_mcd

            v = batch_mcd(batch["mel"], mel.float().cpu().numpy(),
                          batch["mel_mask"].sum(1).astype(int),
                          analysis_power=cfg.norm.analysis_power)
            mcd_vals.append(v)
            print(f"syn set mcd: {v:.3f} dB")
        if not primary:
            continue
        audio = audio.cpu().numpy()
        for k in range(audio.shape[0]):
            dsp_host.write_wav(os.path.join(sample_dir, f"S{k + 1}_B{i + 1}.wav"),
                               finalize_audio(audio[k], cfg), cfg.sampling_rate)
        plot_attention(attn[0].float().cpu().numpy(), i + 1, fig_dir)
        print(f"batch {i + 1}: wrote {audio.shape[0]} wavs to {sample_dir}")
    if n_batches:
        print(f"syn set avg: text2mel {loss_avg_t2m / n_batches:.4f} "
              f"ssrn {loss_avg_ssrn / n_batches:.4f}"
              + (f" mcd {float(np.mean(mcd_vals)):.3f} dB" if mcd_vals else ""))
    return sample_dir


def run_synthesize_tacotron2(args, cfg: Tacotron2Config, device, mesh=None) -> str:
    """Synthesize every line of ``cfg.tts_texts`` with Tacotron 2, row i in the
    voice of the i-th d-vector of ``cfg.spk_emb_dir`` (its ``*.npy``, sorted,
    in turn), in calls of 8 rows: ``S{k}_B{i}.wav`` under
    ``<src_root>/samples/<ctime>/``, each row cut at its stop frame, and each
    call's first attention plot. Over ``mesh``'s ranks only rank 0 writes.
    Returns the sample directory."""
    from spoofsv_torch.data.text import t2_encode_texts
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.infer.synthesize import finalize_audio, gl_seeds
    from spoofsv_torch.spoofkit.spoofgen import load_harvard_sentences
    from spoofsv_torch.train.loop import plot_attention

    syn = build_tacotron2_synthesizer(cfg, device, mesh)
    sentences = load_harvard_sentences(cfg, None)
    names = sorted(f for f in os.listdir(cfg.spk_emb_dir) if f.endswith(".npy"))
    if not names:
        raise ValueError(f"no speaker embeddings (*.npy) in {cfg.spk_emb_dir!r}")
    embs = np.stack([np.load(os.path.join(cfg.spk_emb_dir, n)).astype(np.float32)
                     for n in names])
    primary = mesh is None or mesh.rank == 0
    sample_dir = os.path.join(cfg.src_root_dir, "samples", args.current_time)
    os.makedirs(sample_dir, exist_ok=True)
    seeds = torch.Generator().manual_seed(0)   # the prenet's masks (and a "random" GL init)
    for i, s0 in enumerate(range(0, len(sentences), 8)):
        chunk = sentences[s0: s0 + 8]
        spk = embs[[(s0 + k) % len(names) for k in range(len(chunk))]]
        audio, _, attn = syn(t2_encode_texts(chunk), spk, gl_seeds(len(chunk), seeds))
        if not primary:
            continue
        stops = syn.stop_frames().numpy()
        audio = audio.numpy()
        for k in range(len(chunk)):
            y = audio[k, : cfg.hop_length * int(stops[k])]
            dsp_host.write_wav(os.path.join(sample_dir, f"S{k + 1}_B{i + 1}.wav"),
                               finalize_audio(y, cfg), cfg.sampling_rate)
        plot_attention(attn[0].float().cpu().numpy(), i + 1, os.path.join(sample_dir, "fig"))
        print(f"batch {i + 1}: wrote {len(chunk)} wavs to {sample_dir}")
    return sample_dir


def main(argv=None, device=None):
    """Parse ``argv`` and run the step on ``device`` (the card unless
    ``device="cpu"``). Returns the training step's ``Trainer`` or the
    synthesis step's sample directory."""
    ps = argparse.ArgumentParser(description="Adversarial Conditional Text-to-speech "
                                             "(PyTorch/CUDA)")
    ps.add_argument("step", choices=["train_text2mel", "train_ssrn", "synthesize"],
                    metavar="s")
    ps.add_argument("-P", "--pattern", choices=["universal", "conditional", "ubm-finetune"],
                    default="conditional", metavar="m")
    ps.add_argument("-R", "--resume", type=str, default=None, metavar="checkpoint",
                    help="a checkpoint path, or 'latest' in this run's directory")
    ps.add_argument("-C", "--configuration", type=str, default=None)
    ps.add_argument("--adversarial", action="store_true")
    ps.add_argument("--save_spectrogram", action="store_true",
                    help="cache the features under <SRC_ROOT_DIR>/spec")
    ps.add_argument("-T", "--current_time", type=str, required=True, metavar="T")
    ps.add_argument("--stage", choices=["ubm", "finetune"], default=None,
                    help="stage for the ubm-finetune pattern")
    ps.add_argument("--masked_loss", action="store_true",
                    help="exclude padded frames from the losses (the reference averages over pads)")
    ps.add_argument("--max_iterations", type=int, default=None)
    ps.add_argument("--mcd", action="store_true",
                    help="synthesize: also report the DTW-aligned mel-cepstral distortion "
                         "against the ground truth")
    ps.add_argument("--device_data", choices=["auto", "on", "off"], default="auto",
                    help="keep the bucket-padded training set on the device and gather "
                         "batches there (auto: on for a CUDA device)")
    add_mesh_args(ps)
    ps.add_argument("--metrics_every", type=int, default=1,
                    help="read back and log train metrics every N iterations")
    add_trace_arg(ps)
    args = ps.parse_args(argv)

    device = resolve_device(device)
    cfg = load_config(args.configuration)
    apply_runtime_knobs(cfg, infer=args.step not in TRAIN_STEPS)
    if device.type == "cuda":
        reference_precision()   # f32 means f32: no TF32 convs or matmuls
    spec_dir = None
    if args.save_spectrogram:
        spec_dir = os.path.join(cfg.src_root_dir, "spec")
        os.makedirs(spec_dir, exist_ok=True)
    with data_parallel(args, cfg, device, "spoofsv_torch.cli.main", argv) as mesh, \
            profiling.trace(args.trace_dir):
        if mesh is not None:
            device = mesh.device
        if isinstance(cfg, Tacotron2Config):
            if args.step in TRAIN_STEPS:
                raise NotImplementedError("the port synthesizes with Tacotron 2; its training "
                                          "is not ported")
            return run_synthesize_tacotron2(args, cfg, device, mesh)
        if args.step in TRAIN_STEPS:
            return run_training(args, cfg, spec_dir, device, mesh)
        return run_synthesize(args, cfg, spec_dir, device, mesh)


if __name__ == "__main__":
    main()
