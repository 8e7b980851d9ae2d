"""The port's mesh layer (``spoofsv_torch.parallel``) against the JAX package's, on the CPU.

The port runs one process per device: here two gloo ranks on the CPU, this
test's process as rank 0 and a fresh interpreter as rank 1 (which imports
only ``torch`` and ``spoofsv_torch``: the rank programs are
``spoofsv_torch.parallel.ranks``). The JAX side runs in this process over
``make_mesh(2)`` on ``tests/conftest.py``'s virtual CPU devices, with the
same weights (bridged), the same global batches and the same seeds.

Gates: synthesis mel and attention within 2e-5, audio rel-L2 ≤ 1e-3 and
atol 2e-3 (``test_torch_port_synth.py``'s); 7 WGAN-GP ``Trainer.fit``
iterations with the ranks' parameters bit-equal and within 1e-3 of JAX's
``Trainer(mesh=...)`` (JAX's own gate between its one- and two-process
runs, ``tests/test_multihost.py``), each net's update within 1e-3
(relative L2) of JAX's, the loss logs within 1e-4 of JAX's and the first
gradients within 1e-5 of one rank's; the loader's rows equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu import serve as jserve
from spoofsv_tpu.data import pipeline as jpipeline
from spoofsv_tpu.data import toy as jtoy
from spoofsv_tpu.data import vctk as jvctk
from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.infer.synthesize import Synthesizer as JSynthesizer
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelDisc as JMelDisc
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.parallel.mesh import make_mesh as jmake_mesh
from spoofsv_tpu.train.loop import Trainer as JTrainer
from spoofsv_tpu.train.steps import shift_right
from spoofsv_tpu.utils import torch_export as jexport
from spoofsv_torch import config
from spoofsv_torch.cli import generate_test_utterances as cli_gen
from spoofsv_torch.cli import main as cli
from spoofsv_torch.parallel import mesh as mesh_lib
from spoofsv_torch.parallel import multihost, ranks
from spoofsv_torch.train import TrainState
from spoofsv_torch.train.loop import CheckpointManager

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

NESTED = {"stft": config.STFTConfig, "mel": config.MelConfig, "norm": config.NormConfig,
          "adam": config.AdamConfig, "tpu": config.TPUConfig}


def _port_cfg(jcfg) -> config.Config:
    """The port's ``Config`` with every field of a JAX ``Config`` (a rank
    process unpickles the port's class only)."""
    d = dataclasses.asdict(jcfg)
    return config.Config(**{k: NESTED[k](**v) if k in NESTED else v for k, v in d.items()})


def _spawn(tmp_path, fn, *args, **kw):
    return multihost.spawn(2, fn, *args, devices=("cpu",), run_dir=str(tmp_path / "ranks"),
                           timeout_s=300, **kw)


def _generators(jcfg, seed=0, B=2, N=12):
    """JAX Text2Mel and SSRN initialised from ``seed`` and their exported state dicts."""
    jm = JMelSyn(vocab_len=jcfg.vocab_len, condition=True, spk_emb_dim=jcfg.spk_emb_dim,
                 text_emb_dim=jcfg.text_emb_dim, freq_bins=jcfg.mel.freq_bins,
                 hidden_dim=jcfg.hidden_dim, dtype=jnp.float32)
    js = JSSRN(freq_bins=jcfg.mel.freq_bins, output_bins=jcfg.lin_bins, ssrn_dim=jcfg.ssrn_dim,
               dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    text = jnp.asarray(rng.integers(1, jcfg.vocab_len - 1, (B, N)), jnp.int32)
    spk = jnp.asarray(rng.normal(size=(B, jcfg.spk_emb_dim)), jnp.float32)
    mel = jnp.asarray(rng.uniform(0.05, 0.95, (B, 4, jcfg.mel.freq_bins)), jnp.float32)
    key = jax.random.PRNGKey(seed)
    p1 = jm.init(key, shift_right(mel), text, spk)
    p2 = js.init(key, mel)
    sd = {"text2mel": {k: torch.from_numpy(np.array(v)) for k, v in
                       jexport.export_melsyn(p1).items()},
          "ssrn": {k: torch.from_numpy(np.array(v)) for k, v in jexport.export_ssrn(p2).items()}}
    return (jm, js, p1, p2), sd


def _assert_audio_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel
    np.testing.assert_allclose(got, ref, atol=2e-3)


# ---------------------------------------------------------------------------
# The mesh object and the process group
# ---------------------------------------------------------------------------

def test_single_process_degrades_and_refusals(monkeypatch):
    """No group: ``initialize_distributed`` is a no-op returning False (twice),
    the process is primary, a batch is its own share, and the single-device
    mesh's collectives are the identity; an uneven share asserts; more ranks
    than devices are refused, on a card and on the CPU."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed() is False
    assert multihost.is_primary()
    assert multihost.per_process_batch_size(16) == 16
    mesh = mesh_lib.make_mesh()
    assert (mesh.size, mesh.rank, mesh.staging) == (1, 0, "device")
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(t) is t and mesh.mean(t).equal(t)
    assert mesh_lib.replicated(mesh) == mesh.device == torch.device("cpu")
    local = multihost.global_batch_from_local({"x": np.ones((4, 2), np.float32)}, mesh)
    assert local["x"].shape == (4, 2) and local["x"].device == mesh.device
    assert mesh_lib.batch_sharding(mesh, 5) == slice(0, 5)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = type("A", (), {"mesh": "2", "mesh_share": False})()
    with pytest.raises(ValueError, match="1 CUDA devices"):
        cli.resolve_mesh(args, config.Config(), "cuda")
    args.mesh_share = True
    assert cli.resolve_mesh(args, config.Config(), "cuda") == 2
    args.mesh, args.mesh_share = str(os.cpu_count() + 1), False
    with pytest.raises(ValueError, match="cores"):
        cli.resolve_mesh(args, config.Config(), "cpu")
    args.mesh = "all"
    assert cli.resolve_mesh(args, config.Config(), "cpu") == 1
    two = mesh_lib.Mesh(1, 2, torch.device("cpu"), "gloo")
    assert mesh_lib.batch_sharding(two, 8) == slice(4, 8)
    with pytest.raises(ValueError, match="divide"):
        mesh_lib.batch_sharding(two, 7)


def test_collectives_on_two_gloo_ranks(tmp_path):
    """all_gather (bit-exact bytes, rank order), the broadcast from rank 0,
    the bucketed gradient mean and the object broadcast, on two ranks."""
    r0, r1 = _spawn(tmp_path, ranks.collectives_rank)
    for r in (r0, r1):
        assert sorted(r) == ["gather", "grad", "mean", "object", "weight"]
        for k, (got, want) in r.items():
            assert torch.equal(got, want), k


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["advance", "spsi"])
def test_sharded_synthesizer_matches_jax_mesh(tmp_path, init):
    """``test_parallel_synth.py``'s tiny setup (B=8, N=12, T=8, GL3): the
    port's 2-rank ``Synthesizer`` against JAX's over ``make_mesh(2)``; both
    ranks hold the same gathered result."""
    jcfg = JConfig().replace(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10)
    jcfg = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu, griffin_lim_init=init))
    (jm, js, p1, p2), sd = _generators(jcfg)
    rng = np.random.default_rng(0)
    text = rng.integers(1, jcfg.vocab_len - 1, (8, 12)).astype(np.int32)
    spk = rng.normal(size=(8, jcfg.spk_emb_dim)).astype(np.float32)
    jsyn = JSynthesizer(jcfg, jm, js, p1, p2, n_frames=8, gl_iters=3, mesh=jmake_mesh(2))
    a0, m0, at0 = (np.asarray(x) for x in jsyn(jnp.asarray(text), jnp.asarray(spk),
                                               jax.random.PRNGKey(7)))
    r0, r1 = _spawn(tmp_path, ranks.synth_rank, _port_cfg(jcfg), sd, text, spk, n_frames=8,
                    gl_iters=3)
    for k in ("audio", "mel", "attn"):
        assert torch.equal(r0[k], r1[k]), k
    assert (r0["rows"], r1["rows"]) == ((0, 4), (4, 8))
    assert torch.equal(r1["local"][0], r1["audio"][4:])
    np.testing.assert_allclose(r0["mel"].numpy(), m0, atol=2e-5)
    np.testing.assert_allclose(r0["attn"].numpy(), at0, atol=2e-5)
    _assert_audio_close(r0["audio"].numpy(), a0)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _masks(rng, B, N, T):
    tl = rng.integers(N // 2, N + 1, B)
    fl = rng.integers(T // 3, T + 1, B)
    mel_mask = (np.arange(T)[None] < fl[:, None]).astype(np.float32)
    text_mask = (np.arange(N)[None] < tl[:, None]).astype(np.float32)
    return {"mel_mask": mel_mask, "att_mask": text_mask[:, :, None] * mel_mask[:, None, :]}


def _rel_l2(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every entry of two dicts of arrays, as one f64 vector."""
    num = den = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        num += float(((np.asarray(got[k], np.float64) - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def _updates_vs_jax(final: dict, init: dict, jfinal: dict) -> dict:
    """Each net's update (final − initial) against JAX's, as a relative L2 norm."""
    out = {}
    for net in ("gen", "disc"):
        start = {k: v.double().numpy() for k, v in init[net].items()}
        out[net] = _rel_l2({k: final[net][k].double().numpy() - v for k, v in start.items()},
                           {k: np.asarray(jfinal[net][k], np.float64) - v
                            for k, v in start.items()})
    return out


# limits of the WGAN-GP test, from its readings on the CPU (f32 on both
# sides): update gaps ≤ 8.9e-5 (plain) and 5.2e-5 (masks), the loss logs ≤
# 2.2e-6 apart, the first gradients of 2 ranks and of 1 ≤ 8.0e-7. A masked
# mean taken as the mean of the shards' means moves the masked case's
# generator update by 8.6e-2; gradients summed over the ranks, not averaged,
# move it by 5.7e-3
UPDATE_GAP, LOG_GAP, GRAD_GAP = 1e-3, 1e-4, 1e-5


@pytest.mark.parametrize("use_masks", [False, True])
def test_two_rank_wgan_gp_trainer_matches_jax_mesh(tmp_path, use_masks):
    """7 WGAN-GP ``Trainer.fit`` iterations (1 G, 5 D, 1 G) on 2 ranks from
    JAX-initialised weights, JAX's penalty draws for the global batch handed
    in. The ranks' generator, critic and Adam moments are bit-equal. Against
    JAX's ``Trainer(mesh=make_mesh(2))`` on the same global batches: both
    nets within 1e-3 of JAX's (a gate as large as the whole update), each
    net's update (final − initial) within a relative L2 of ``UPDATE_GAP`` of
    JAX's (a net that did not move reads 1), and every logged loss (the G
    loss, its critic term, the D loss, the Wasserstein estimate) within
    ``LOG_GAP`` relative; Adam's near-sign steps hide a gradient's scale,
    so the first G and D steps' all-reduced gradients are also held to a
    single rank's on the same global batches (``GRAD_GAP``; summed, not
    averaged, they read 1). With ``use_masks`` the rows' lengths differ, so
    the shards' counts differ and only the global masked mean matches: the
    first G loss comes from the same weights on both sides."""
    jcfg = JConfig().replace(hidden_dim=32, text_emb_dim=16, disc_dim=16, spk_emb_dim=20,
                             max_text_len=30, max_frame_num=16,
                             src_root_dir=str(tmp_path / "jax") + "/", val_every_iter=10 ** 9)
    model = JMelSyn(vocab_len=jcfg.vocab_len, condition=True, spk_emb_dim=20, text_emb_dim=16,
                    freq_bins=jcfg.mel.freq_bins, hidden_dim=32)
    disc = JMelDisc(disc_dim=16)
    B, T, N = 8, 16, 24
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        b = {"mel": rng.uniform(0.05, 0.95, (B, T, jcfg.mel.freq_bins)).astype(np.float32),
             "text": rng.integers(1, jcfg.vocab_len - 1, (B, N)).astype(np.int32),
             "spk": rng.normal(size=(B, 20)).astype(np.float32)}
        if use_masks:
            b.update(_masks(rng, B, N, T))
        batches.append(b)
    trainer = JTrainer(jcfg, model, "train_text2mel", adversarial=True, gan_type="wgan-gp",
                       disc_model=disc, validate_with_decode=False, mesh=jmake_mesh(2),
                       use_masks=use_masks, ctime="mesh")
    trainer.init(jax.random.PRNGKey(0), batches[0])
    gen0 = {k: torch.from_numpy(np.array(v))
            for k, v in jexport.export_melsyn(trainer.state.gen_params).items()}
    disc0 = {k: torch.from_numpy(np.array(v))
             for k, v in jexport.export_critic(trainer.state.disc_params).items()}
    # Trainer.fit's keys: split per iteration; a D step draws from its key's second half
    draws, key = [], jax.random.PRNGKey(0)
    for i in range(7):
        key, sub = jax.random.split(key)
        if i % (jcfg.ratio + 1):
            draws.append(np.asarray(jax.random.uniform(jax.random.split(sub)[1], (B, 1, 1),
                                                       jnp.float32)))
    trainer.fit(lambda: iter(batches), max_epochs=10 ** 9, max_iterations=7, rng_seed=0)
    jfinal = {"gen": jexport.export_melsyn(trainer.state.gen_params),
              "disc": jexport.export_critic(trainer.state.disc_params)}
    trainer._flush_loss_logs()
    jlogs = trainer.loss_logs

    args = (_port_cfg(jcfg), "train_text2mel", gen0, disc0, batches, 7)
    kw = dict(use_masks=use_masks, draws=draws)
    r0, r1 = _spawn(tmp_path, ranks.train_rank, *args, workdir=str(tmp_path / "port"), **kw)
    assert r0["iteration"] == r1["iteration"] == 7
    for part in ("gen", "disc", "moments"):
        assert sorted(r0[part]) == sorted(r1[part])
        for k in r0[part]:
            assert torch.equal(r0[part][k], r1[part][k]), (part, k)
    assert len(r0["moments"]) > 0
    assert r0["loss_logs"] == r1["loss_logs"] and len(r0["loss_logs"]["wd"]) == 5

    init = {"gen": gen0, "disc": disc0}
    worst = 0.0
    for net in ("gen", "disc"):
        assert sorted(r0[net]) == sorted(jfinal[net])
        for k, v in jfinal[net].items():
            worst = max(worst, float(np.abs(r0[net][k].double().numpy()
                                            - np.asarray(v, np.float64)).max()))
    assert worst < 1e-3, worst   # JAX's own gate between its one- and two-process runs
    gaps = _updates_vs_jax(r0, init, jfinal)
    assert max(gaps.values()) <= UPDATE_GAP, gaps
    # a net that did not move is far outside the gate
    assert min(_updates_vs_jax(init, init, jfinal).values()) > 100 * UPDATE_GAP
    assert sorted(jlogs) == sorted(r0["loss_logs"])
    log_gap = 0.0
    for k, want in jlogs.items():
        got = r0["loss_logs"][k]
        assert len(got) == len(want), k
        # each log's gap relative to its largest value; the G loss, recon plus
        # recon·loss_disc/|loss_disc|, is 0 up to rounding, so its gap is absolute
        scale = 1.0 if k == "t_s" else max(abs(b) for b in want)
        log_gap = max([log_gap] + [abs(a - b) / scale for a, b in zip(got, want)])
    assert log_gap <= LOG_GAP, (log_gap, r0["loss_logs"], jlogs)

    one = ranks.train_rank(mesh_lib.make_mesh(device="cpu"), *args,
                           workdir=str(tmp_path / "one"), **kw)
    grad_gap = {net: _rel_l2({k: v.double().numpy() for k, v in r0["first_grads"][net].items()},
                             {k: v.double().numpy() for k, v in one["first_grads"][net].items()})
                for net in ("gen", "disc")}
    print(f"[mesh wgan-gp use_masks={use_masks}] update gaps {gaps}, loss-log gap {log_gap:.3g}, "
          f"first-gradient gaps (2 ranks vs 1) {grad_gap}")
    assert max(grad_gap.values()) <= GRAD_GAP, grad_gap


# ---------------------------------------------------------------------------
# The mesh-aware loader
# ---------------------------------------------------------------------------

def test_two_rank_device_replay_loader_matches_jax_mesh(tmp_path):
    """Each step, rank 0's rows then rank 1's are the JAX mesh loader's
    global batch, chunks trimmed to a multiple of 2, over two epochs."""
    jtoy.generate_toy_corpus(str(tmp_path / "c"), str(tmp_path / "emb"), n_speakers=3,
                             utts_per_spk=9, seed=5, rich_speakers=True)
    jcfg = JConfig().replace(data_root_dir=str(tmp_path / "c"), spk_emb_dir=str(tmp_path / "emb"))
    jvctk.prepare_vctk(jcfg, verbose=False)
    jl = jpipeline.DeviceReplayLoader(jpipeline.TTSDataSource(jcfg, "train"), 3, seed=4,
                                      mesh=jmake_mesh(2))
    want = [jax.device_get(b) for _ in range(2) for b in jl]
    cfg = _port_cfg(jcfg)
    r0, r1 = _spawn(tmp_path, ranks.loader_rank, cfg, 3, 4, 2)
    assert len(r0) == len(r1) == len(want) > 0
    for a, b, w in zip(r0, r1, want):
        assert sorted(a) == sorted(w)
        for k in w:
            assert a[k].shape[0] == b[k].shape[0]
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), np.asarray(w[k]))
    assert {len(b["mel"]) for b in want} <= {2}   # chunks of 3 trimmed to 2


# ---------------------------------------------------------------------------
# The spoof-set CLI and serving
# ---------------------------------------------------------------------------

def test_spoof_set_cli_over_two_ranks(tmp_path):
    """``generate_test_utterances --mesh 2`` on the CPU: 3 utterances a
    speaker and one speaker a call, so each call is padded from 3 rows to
    4 and sliced back; rank 0 alone writes the set, and its wavs match the
    single-process CLI's within the slice's audio gates (each rank runs 2
    rows where one process runs 3, and the CPU's convolutions round by the
    batch: a few 16-bit samples move by one step)."""
    cfg = config.Config().replace(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10,
                                  max_frame_num=8,
                                  src_root_dir=str(tmp_path / "run") + "/",
                                  data_root_dir=str(tmp_path / "data"),
                                  spk_emb_dir=str(tmp_path / "emb"),
                                  tts_texts=str(tmp_path / "havard.txt"))
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, griffin_lim_iters=3))
    (tmp_path / "havard.txt").write_text("The birch canoe slid.\nGlue the sheet.\n"
                                         "It is easy to tell.\nRice is served.\n")
    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "emb")
    for s in ("p225", "p226"):
        os.makedirs(tmp_path / "data" / "wav22" / s)
        np.save(tmp_path / "emb" / f"{s}.npy", rng.normal(size=10).astype(np.float32))
    torch.manual_seed(0)
    melsyn, ssrn, _, _ = cli.build_models(cfg, device="cpu")
    ckpt = {}
    for kind, model in (("text2mel", melsyn), ("ssrn", ssrn)):
        mgr = CheckpointManager(cfg, "conditional", False, "ck", f"train_{kind}")
        ckpt[kind] = mgr.save(TrainState(0, model, torch.optim.Adam(model.parameters())),
                              {"epoch": 0, "iteration": 1, "loss_val_log": []})
    cfg = cfg.replace(inference_text2mel_model=ckpt["text2mel"],
                      inference_ssrn_model=ckpt["ssrn"])
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(cfg.to_reference_dict()))
    argv = ["-C", str(conf), "--eval_utt_num", "3", "--speaker_batch", "1", "--skip_staging"]
    cli_gen.main(argv + ["-T", "one"], device="cpu")
    cli_gen.main(argv + ["-T", "two", "--mesh", "2"], device="cpu")
    from spoofsv_torch.dsp import host

    root = tmp_path / "run" / "test"
    one = sorted(p.relative_to(root / "one").as_posix() for p in (root / "one").rglob("*.wav"))
    two = sorted(p.relative_to(root / "two").as_posix() for p in (root / "two").rglob("*.wav"))
    assert one == two and len(one) == 6
    for rel in one:
        _assert_audio_close(host.load_wav(str(root / "two" / rel))[0],
                            host.load_wav(str(root / "one" / rel))[0])


def test_two_rank_serving_matches_jax_mesh_serve(tmp_path):
    """The ladder's base rung is the rank count (max_batch 6 → [2, 4, 6]);
    HTTP replies from rank 0's server, each solo request padded to 2 rows
    split over the 2 ranks, against JAX's batcher over ``make_mesh(2)``."""
    tiny = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10, max_text_len=16,
                max_frame_num=8)
    jcfg = JConfig().replace(**tiny)
    jcfg = jcfg.replace(tpu=dataclasses.replace(jcfg.tpu, griffin_lim_iters=3))
    (jm, js, p1, p2), sd = _generators(jcfg, N=jcfg.max_text_len)
    jsyn = JSynthesizer(jcfg, jm, js, p1, p2, n_frames=8, gl_iters=3, mesh=jmake_mesh(2))
    jb = jserve.BatchingSynthesizer(jcfg, jsyn, max_batch=6, trim_db=None)
    texts = ["mesh solo one", "a second one", "three"]
    spks = [np.full(10, v, np.float32) for v in (0.0, 0.5, -0.25)]
    try:
        assert jb._ladder() == [2, 4, 6]
        want = [jb.synthesize(t, s, timeout=300) for t, s in zip(texts, spks)]
    finally:
        jb.close()
    reqs = [{"text": t, "spk_emb": s.tolist(), "format": "json"} for t, s in zip(texts, spks)]
    r0, r1 = multihost.spawn(2, ranks.serve_rank, _port_cfg(jcfg), sd, reqs, max_batch=6,
                             devices=("cpu",), run_dir=str(tmp_path / "ranks"), timeout_s=300)
    assert r0["ladder"] == [2, 4, 6]
    assert r1["calls"] == len(texts)
    for (status, body), ref in zip(r0["replies"], want):
        assert status == 200
        _assert_audio_close(np.asarray(body["samples"], np.float32), ref)


# ---------------------------------------------------------------------------
# Pieces that need no process group
# ---------------------------------------------------------------------------

def test_place_batch_trims_to_the_rank_multiple(tiny_cfg, tmp_path, capsys):
    """Over a mesh, the Trainer takes this rank's rows of each global batch
    after trimming it to a multiple of the rank count (printed once), skips
    a batch with fewer rows than ranks, and takes a ``LocalRows`` batch as
    it is (the JAX ``_place_batch``'s trim and its placed-batch no-op)."""
    from spoofsv_torch.train import Trainer

    cfg = _port_cfg(tiny_cfg).replace(src_root_dir=str(tmp_path) + "/")
    gen = cli.build_models(cfg, device="cpu")[1]
    rank1 = mesh_lib.Mesh(1, 2, torch.device("cpu"), "gloo")
    trainer = Trainer(cfg, gen, "train_ssrn", mesh=rank1, ctime="trim")
    assert not trainer.primary and trainer.metrics.path is None
    batch = {"mel": np.arange(7)[:, None].astype(np.float32)}
    for _ in range(2):
        got = trainer._place_batch(batch)
        assert got["mel"][:, 0].tolist() == [3.0, 4.0, 5.0]
    assert capsys.readouterr().out.count("[mesh] trimming uneven batch 7 -> 6") == 1
    assert trainer._place_batch({"mel": np.zeros((1, 1), np.float32)}) is None
    local = mesh_lib.LocalRows(mel=torch.ones(2, 1))
    assert torch.equal(trainer._place_batch(local)["mel"], torch.ones(2, 1))


@pytest.mark.parametrize("ranks_n,max_batch,ladder", [(1, 8, [1, 2, 4, 8]), (2, 6, [2, 4, 6]),
                                                     (4, 6, [4, 8]), (2, 1, [2])])
def test_serving_ladder_base_is_the_rank_count(ranks_n, max_batch, ladder):
    """JAX's ladder rule: the base rung is the rank count and every rung a
    multiple of it (``spoofsv_tpu/serve.py:426-439``)."""
    from types import SimpleNamespace

    from spoofsv_torch.serve import BatchingSynthesizer

    mesh = None if ranks_n == 1 else mesh_lib.Mesh(0, ranks_n, torch.device("cpu"), "gloo")
    fake = SimpleNamespace(mesh=mesh, _ladder=None)
    assert BatchingSynthesizer._ladder(SimpleNamespace(syn=fake, max_batch=max_batch)) == ladder
    assert all(r % ranks_n == 0 for r in ladder)


def test_dryrun_multichip_on_two_cpu_ranks(tmp_path, capsys):
    """``parallel.dryrun``: one adversarial step and one sharded synthesis
    call at the reference's widths over 2 gloo ranks, the JAX dryrun's OK
    lines, the ranks' results equal."""
    from spoofsv_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, "cpu", run_dir=str(tmp_path / "ranks"))
    assert len(out) == 2 and out[0] == out[1]
    assert out[0]["audio_shape"] == (4, 256 * (4 * 80 - 1))
    printed = capsys.readouterr().out
    assert "dryrun_multichip(2): OK — G loss=" in printed
    assert "dryrun_multichip(2): inference OK — sharded synthesis B=4" in printed


def test_spoof_set_takes_any_synthesizer_callable(tmp_path):
    """``generate_spoof_set`` over a plain callable (no ``mesh``), as
    ``chip_smoke.py`` times one: one call of speakers x utterances rows."""
    from spoofsv_torch.spoofkit import spoofgen

    cfg = config.Config().replace(src_root_dir=str(tmp_path) + "/",
                                  spk_emb_dir=str(tmp_path / "emb"),
                                  tts_texts=str(tmp_path / "h.txt"))
    (tmp_path / "h.txt").write_text("One.\nTwo.\n")
    os.makedirs(tmp_path / "emb")
    for s in ("p225", "p226"):
        np.save(tmp_path / "emb" / f"{s}.npy", np.zeros(cfg.spk_emb_dim, np.float32))
    calls = []

    def synth(text, spk, seeds):
        calls.append(len(text))
        audio = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (len(text), 2048)))
        return audio.float(), None, None

    out = spoofgen.generate_spoof_set(cfg, "c", synth, eval_utt_num=2, speakers=["p225", "p226"],
                                      verbose=False)
    assert calls == [4] and len(os.listdir(os.path.join(out, "s225"))) == 2
