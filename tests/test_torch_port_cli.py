"""``python -m spoofsv_torch.cli.main`` on the CPU, on a 2-speaker toy corpus.

Training (``train_text2mel --adversarial``, ``train_ssrn`` with the batches
on the device, ``-R latest``), the mesh refusal (more ranks than cores)
beside the runs it does not refuse (``--mesh all`` and ``MULTI_GPU`` on one device,
bf16 training, a FLAC corpus), and ``synthesize`` from reference ``.tar.pth``
checkpoints written from JAX parameters, against the JAX CLI's own
``synthesize`` on the same checkpoints: the same wav files, samples within
``tests/test_torch_port_spoofgen.py``'s atol 2e-3.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from spoofsv_tpu.cli import main as jcli
from spoofsv_tpu.config import load_config as jload_config
from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.train.steps import shift_right
from spoofsv_tpu.utils.torch_export import (export_melsyn, export_ssrn,
                                            save_reference_checkpoint)
from spoofsv_torch.cli import main as cli
from spoofsv_torch.data.toy import generate_toy_corpus, toy_config
from spoofsv_torch.data.vctk import prepare_vctk
from spoofsv_torch.dsp import host
from spoofsv_torch.models import layers

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

TINY = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=8, disc_dim=8, batch_size=4,
            val_every_iter=3, max_epochs=50)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """2 speakers x 8 utterances (4 train, 6 validate, 6 synthesize), prepared."""
    root = tmp_path_factory.mktemp("cli")
    generate_toy_corpus(str(root / "data"), str(root / "emb"), n_speakers=2, utts_per_spk=8,
                        seed=3)
    prepare_vctk(toy_config(str(root / "data"), str(root / "emb"), str(root)), verbose=False)
    return root


def _config(root, work: str, **kw) -> str:
    cfg = toy_config(str(root / "data"), str(root / "emb"), str(root / work) + "/", **TINY)
    cfg = cfg.replace(**kw)
    path = root / f"{work}.json"
    path.write_text(json.dumps(cfg.to_reference_dict()))
    return str(path)


def _metrics(base):
    with open(os.path.join(base, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_train_text2mel_adversarial_then_resume_latest(toy_root):
    """7 iterations at ratio 5: G at 0 and 6, D at 1-5; validation and
    checkpoints at 3 and 6 (AR decode on the CPU); ``-R latest`` resumes
    from iteration 6 and trains to 9."""
    conf = _config(toy_root, "adv")
    with layers.gate_impl("xla"):
        trainer = cli.main(["train_text2mel", "-C", conf, "-T", "t1", "--adversarial",
                            "--max_iterations", "7", "--masked_loss"], device="cpu")
    base = toy_root / "adv" / "checkpoints" / "conditional" / "adversarial" / "t1"
    assert trainer.iteration == 7 and trainer.ckpt.base == str(base)
    assert {k: len(v) for k, v in trainer.loss_logs.items()} == {"t_s": 2, "t_s_o": 2,
                                                                 "t_d": 5, "wd": 5}
    names = set(os.listdir(base))
    assert {"text2mel_iteration_3.tar.pth", "text2mel_iteration_6.tar.pth",
            "text2mel_best_model.tar.pth", "metrics.jsonl"} <= names
    ck = torch.load(base / "text2mel_iteration_6.tar.pth", map_location="cpu", weights_only=True)
    assert {"disc_state_dict", "optimizer_state_dict", "disc_optimizer_state_dict",
            "model_state_dict", "loss_logs"} <= set(ck)
    assert {k: len(v) for k, v in ck["loss_logs"].items()} == {"t_s": 1, "t_s_o": 1,
                                                               "t_d": 5, "wd": 5}
    train = [r for r in _metrics(base) if r["split"] == "train"]
    assert len(train) == 7 and all(np.isfinite(r.get("loss", r.get("loss_d"))) for r in train)
    assert {r["iteration"] for r in _metrics(base) if r["split"] == "validate"} == {3, 6}

    with layers.gate_impl("xla"):
        again = cli.main(["train_text2mel", "-C", conf, "-T", "t1", "--adversarial", "-R",
                          "latest", "--max_iterations", "9"], device="cpu")
    assert again.iteration == 9
    assert {k: len(v) for k, v in again.loss_logs.items()} == {"t_s": 2, "t_s_o": 2,
                                                               "t_d": 7, "wd": 7}
    assert again.ckpt.latest().endswith("text2mel_iteration_9.tar.pth")


def test_train_ssrn_with_device_data_and_cache(toy_root):
    """``--device_data on`` puts the training set on the (CPU) device and
    logs its bytes; ``--save_spectrogram`` fills the feature cache."""
    conf = _config(toy_root, "ssrn")
    with layers.gate_impl("xla"):
        trainer = cli.main(["train_ssrn", "-C", conf, "-T", "s1", "--max_iterations", "3",
                            "--device_data", "on", "--save_spectrogram"], device="cpu")
    assert trainer.iteration == 3 and not trainer.adversarial
    data = [r for r in _metrics(trainer.ckpt.base) if r["split"] == "data"]
    assert len(data) == 1 and data[0]["utterances"] == 4 and data[0]["device_bytes"] > 0
    spec = toy_root / "ssrn" / "spec"
    assert len(list(spec.glob("*_lin.npy"))) == 4 + 6   # train, then validation
    ck = torch.load(trainer.ckpt.latest(), map_location="cpu", weights_only=True)
    assert set(ck) == {"epoch", "iteration", "model_state_dict", "optimizer_state_dict",
                       "loss_val_log"}


def test_refusals(toy_root, tmp_path):
    """A mesh of more ranks than the host has cores is refused (``--mesh N``
    runs N ranks since the mesh layer was ported;
    ``tests/test_torch_port_mesh.py`` runs them). ``--mesh all`` and
    ``MULTI_GPU`` on the one visible (CPU) device train single-device, as
    the JAX ``resolve_mesh`` runs them; ``train_compute_dtype="bfloat16"``
    trains under autocast; a corpus of FLAC files is read, to the JAX
    reader's samples."""
    conf = _config(toy_root, "refuse")
    base = ["train_text2mel", "-C", conf, "-T", "r", "--max_iterations", "1"]
    with pytest.raises(ValueError, match="cores"):
        cli.main(base + ["--mesh", str(os.cpu_count() + 1)], device="cpu")
    bf16 = _config(toy_root, "bf16")
    d = json.loads(open(bf16).read())
    d["TPU"] = {"train_compute_dtype": "bfloat16"}
    open(bf16, "w").write(json.dumps(d))
    with layers.gate_impl("xla"):
        assert cli.main(base + ["--mesh", "all"], device="cpu").iteration == 1
        multi = _config(toy_root, "multi", multi_gpu=True)
        assert cli.main(["train_ssrn", "-C", multi, "-T", "r", "--max_iterations", "1"],
                        device="cpu").iteration == 1
        trainer = cli.main(["train_ssrn", "-C", bf16, "-T", "r", "--max_iterations", "1"],
                           device="cpu")
    assert trainer.iteration == 1 and next(trainer.gen_model.parameters()).dtype == torch.float32
    train = [r for r in _metrics(trainer.ckpt.base) if r["split"] == "train"]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])
    # a corpus of FLAC files: read, and read as the JAX package reads it
    lists = toy_root / "data" / "data_path" / "ordinary"
    wav = open(lists / "wav.path.train").readline().strip()
    txt = open(lists / "txt.path.train").readline().strip()
    flac_root = tmp_path / "flac"
    flac_lists = flac_root / "data_path" / "ordinary"
    flac_lists.mkdir(parents=True)
    y, sr = host.load_wav(wav)
    flac = str(flac_root / (os.path.basename(wav)[:-4] + ".flac"))
    host.write_flac(flac, y, sr)
    np.testing.assert_array_equal(host.load_wav(flac)[0], jhost.load_wav(flac)[0])
    for mode in ("train", "validate", "synthesize"):
        (flac_lists / f"wav.path.{mode}").write_text(flac + "\n")
        (flac_lists / f"txt.path.{mode}").write_text(txt + "\n")
    flac_conf = _config(toy_root, "flac", data_root_dir=str(flac_root))
    with layers.gate_impl("xla"):
        got = cli.main(["train_text2mel", "-C", flac_conf, "-T", "r", "--device_data", "on",
                        "--max_iterations", "1"], device="cpu")
    assert got.iteration == 1
    with pytest.raises(SystemExit):
        cli.main(["train_text2mel", "-P", "bogus", "-T", "x"], device="cpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0


@pytest.fixture
def restore_jax_cache_dir():
    """The JAX CLI points the process's compilation cache elsewhere; put it back."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def _jax_checkpoints(toy_root, tmp_path):
    """Reference ``.tar.pth`` checkpoints of JAX-initialised Text2Mel and SSRN."""
    jcfg = jload_config(_config(toy_root, "probe"))
    melsyn, ssrn, _, _ = jcli.build_models(jcfg, "conditional")
    rng = np.random.default_rng(0)
    mel = jnp.asarray(rng.uniform(0.05, 0.95, (1, 8, 80)), jnp.float32)
    p1 = melsyn.init(jax.random.PRNGKey(1), shift_right(mel), jnp.ones((1, 10), jnp.int32),
                     jnp.zeros((1, 200), jnp.float32))
    p2 = ssrn.init(jax.random.PRNGKey(2), mel)
    t2m, ss = str(tmp_path / "t2m.tar.pth"), str(tmp_path / "ssrn.tar.pth")
    save_reference_checkpoint(t2m, export_melsyn(p1))
    save_reference_checkpoint(ss, export_ssrn(p2))
    return jcfg, t2m, ss


def test_synthesize_matches_the_jax_cli(toy_root, tmp_path, restore_jax_cache_dir):
    """Reference checkpoints of JAX-initialised parameters, synthesized by both
    CLIs (f32 on the CPU, GL12): the same ``S{k}_B{i}.wav`` names, lengths
    and samples within 2e-3, the port's run under ``--trace_dir`` (a Chrome
    trace holding its ``spoofsv.synth.call`` spans). The phase init is
    "advance": the mel and lin agree to ~1e-5 (the losses to 7 digits), but
    SPSI's peak picking is a discrete choice that such differences flip on
    near-tied bins, which moved 3 of these 6 utterances by up to 3.7e-3
    before the peak normalisation.
    The default SPSI init is held end to end on equal inputs by
    :func:`test_spsi_vocoder_on_the_jax_cli_lin`."""
    jcfg, t2m, ss = _jax_checkpoints(toy_root, tmp_path)
    out = {}
    trace_dir = tmp_path / "trace"
    port = lambda a: cli.main(a + ["--trace_dir", str(trace_dir)], device="cpu")  # noqa: E731
    for side, run in (("jax", jcli.main), ("port", port)):
        conf = _config(toy_root, f"syn_{side}", inference_text2mel_model=t2m,
                       inference_ssrn_model=ss,
                       tpu=dataclasses.replace(jcfg.tpu, griffin_lim_init="advance"))
        with layers.gate_impl("xla"):
            run(["synthesize", "-C", conf, "-T", "s"])
        d = toy_root / f"syn_{side}" / "samples" / "s"
        out[side] = {p.name: wavfile.read(p) for p in d.glob("*.wav")}
    assert sorted(out["port"]) == sorted(out["jax"])
    assert sum(1 for n in out["port"] if n.startswith("S")) == 6
    for name, (sr, y) in out["port"].items():
        jsr, jy = out["jax"][name]
        assert sr == jsr and len(y) == len(jy) > 0, name
        np.testing.assert_allclose(y / 32767.0, jy / 32767.0, atol=2e-3, err_msg=name)
    assert (toy_root / "syn_port" / "samples" / "s" / "fig" / "att_iteration_1.png").exists()
    trace, = trace_dir.glob("*.json")
    assert '"spoofsv.synth.call"' in trace.read_text()


def test_spsi_vocoder_on_the_jax_cli_lin(toy_root, tmp_path, restore_jax_cache_dir,
                                         monkeypatch):
    """The JAX CLI's ``synthesize`` with the default SPSI init; each batch's
    linear spectrogram it computed goes through the port's vocoder and the
    JAX one, then each side's ``finalize_audio``: samples within 2e-3 for every
    wav the CLI wrote, SPSI's peak picking checked end to end on equal inputs.
    (The CLI's wavs come from its one-program SSRN and vocoder, whose lin
    rounds apart from the separate SSRN call the CLI scores; that alone moves
    the JAX package's own SPSI audio by up to ~1.6e-3 here, so the files are
    held by name and length.)"""
    from spoofsv_tpu.infer import synthesize as jsyn
    from spoofsv_torch.config import load_config
    from spoofsv_torch.infer.synthesize import finalize_audio, make_vocoder

    jcfg, t2m, ss = _jax_checkpoints(toy_root, tmp_path)
    assert jcfg.tpu.griffin_lim_init == "spsi"
    lins = []
    jinit = jsyn.Synthesizer.__init__

    def recording_init(self, *a, **kw):
        jinit(self, *a, **kw)
        ssrn_apply = self._ssrn_apply

        def apply(p, mel):
            lin = ssrn_apply(p, mel)
            lins.append(np.array(lin))
            return lin

        self._ssrn_apply = apply

    monkeypatch.setattr(jsyn.Synthesizer, "__init__", recording_init)
    conf = _config(toy_root, "syn_spsi", inference_text2mel_model=t2m, inference_ssrn_model=ss)
    with layers.gate_impl("xla"):
        jcli.main(["synthesize", "-C", conf, "-T", "s"])
    d = toy_root / "syn_spsi" / "samples" / "s"
    pcfg, jc = load_config(conf), jload_config(conf)
    port_vocode, jax_vocode = make_vocoder(pcfg), jsyn.make_vocoder(jc)
    n = 0
    for i, lin in enumerate(lins):
        audio = port_vocode(torch.from_numpy(lin)).numpy()
        ref = np.asarray(jax_vocode(jnp.asarray(lin), jax.random.PRNGKey(0)))
        for k in range(audio.shape[0]):
            sr, jy = wavfile.read(d / f"S{k + 1}_B{i + 1}.wav")
            y, yr = finalize_audio(audio[k], pcfg), np.asarray(jsyn.finalize_audio(ref[k], jc))
            assert sr == pcfg.sampling_rate and len(y) == len(yr) == len(jy) > 0, (i, k)
            np.testing.assert_allclose(y, yr, atol=2e-3, err_msg=f"S{k + 1}_B{i + 1}")
            n += 1
    assert n == len(list(d.glob("S*.wav"))) == 6
