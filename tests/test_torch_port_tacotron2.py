"""The port's multi-speaker Tacotron 2 against the plain reference, on the CPU.

``plainref/tacotron2.py`` is the model's equations in float32 torch;
``spoofsv_torch`` runs it through ``Tacotron2Synthesizer`` (the encoder, the
rollout's plain steps over its operand layout, the folded postnet, the mel's
pseudo-inverse). Tiny widths and seeded random weights, no kernel build.
Tolerances: the two compute the same float32 arithmetic in another order
(1e-5 on the encoder and the postnet, 1e-4 over a 110-step rollout, whose
state carries the differences along).
"""

import dataclasses

import numpy as np
import pytest
import torch

from plainref import tacotron2 as ref
from spoofsv_torch.config import Tacotron2Config
from spoofsv_torch.data.text import t2_encode_texts
from spoofsv_torch.infer.synthesize import (Tacotron2Synthesizer, mel_pseudo_inverse,
                                            mel_to_linear)
from spoofsv_torch.models.tacotron2 import Tacotron2, build_tacotron2
from spoofsv_torch.ops import t2_kernel

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

TINY = dict(symbols_embedding_dim=16, encoder_embedding_dim=16, speaker_embedding_dim=8,
            n_mel_channels=8, attention_rnn_dim=32, decoder_rnn_dim=24, prenet_dim=16,
            attention_dim=8, attention_location_n_filters=4, attention_location_kernel_size=7,
            postnet_embedding_dim=16, weights_seed=3, max_decoder_steps=24)
TEXTS = ["The birch canoe slid on the smooth planks.", "Rice is often served in round bowls.",
         "It's easy to tell."]


@pytest.fixture(scope="module")
def tiny():
    cfg = Tacotron2Config.from_hparams({**TINY, "TPU": {"griffin_lim_iters": 2}})
    hp = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    model = build_tacotron2(cfg, "cpu")
    sd = model.state_dict()
    g = torch.Generator().manual_seed(1)
    ids = torch.from_numpy(t2_encode_texts(TEXTS))
    dvec = torch.randn(len(TEXTS), 8, generator=g)
    seeds = torch.tensor([5, 2 ** 31 - 2, -7], dtype=torch.int32)
    return cfg, hp, model, sd, ids, dvec, seeds


def test_nvidia_schema_loads_strict():
    """The module tree is NVIDIA's at the published widths (memory 768 wide),
    and a state dict of exactly the reference's names and shapes loads with
    ``strict=True``, BatchNorm buffers included."""
    cfg = Tacotron2Config()
    hp = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    with torch.device("meta"):
        model = Tacotron2(cfg)
    schema = ref.schema(hp)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == schema
    assert dict(schema)["decoder.attention_layer.memory_layer.linear_layer.weight"] == (128, 768)
    small = Tacotron2Config.from_hparams(TINY)
    state = {k: (torch.zeros((), dtype=torch.int64) if s == () else torch.randn(s))
             for k, s in ref.schema({f.name: getattr(small, f.name)
                                     for f in dataclasses.fields(small)})}
    Tacotron2(small).load_state_dict(state, strict=True)


def test_text_ids_are_the_references():
    from pathlib import Path

    harvard = Path(__file__).resolve().parent.parent / "portbench" / "data" / "harvard.txt"
    sentences = [ln.strip() for ln in open(harvard) if ln.strip()][:20]
    ids = t2_encode_texts(sentences + ["Mr. Smith  met Dr. Who (at 9)!"])
    assert np.array_equal(ids, ref.encode_texts(sentences + ["Mr. Smith  met Dr. Who (at 9)!"]))
    assert (ids[:20] != 0).sum(1).max() == 49


def test_encoder_padded_rows_equal_each_row_alone(tiny):
    cfg, hp, model, sd, ids, dvec, _ = tiny
    lengths = (ids != 0).sum(1)
    memory, pm = model.encode(ids, lengths, dvec)
    want = ref.encoder(sd, ids, dvec, hp)
    assert float((memory - want).abs().max()) < 1e-5
    for i in range(len(ids)):
        n = int(lengths[i])
        alone, _ = model.encode(ids[i:i + 1, :n], lengths[i:i + 1], dvec[i:i + 1])
        assert float((alone[0] - memory[i, :n]).abs().max()) < 1e-5
        assert not memory[i, n:, :cfg.encoder_embedding_dim].any()
    w = sd["decoder.attention_layer.memory_layer.linear_layer.weight"]
    assert float((pm - want @ w.t()).abs().max()) < 1e-5


def test_prenet_masks_are_the_references():
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, -2 ** 31, 123456789], dtype=torch.int32)
    for step, layer in ((0, 0), (1, 1), (999, 0), (2 ** 20, 1)):
        assert torch.equal(t2_kernel.mask_hash_plain(seeds, step, layer, 256),
                           ref.mask_hash(seeds, step, layer, 256))
        keep = t2_kernel.prenet_mask_plain(seeds, step, layer, 256, 0.5)
        assert torch.equal(keep, ref.prenet_keep(seeds, step, layer, 256, 0.5))
        assert 0.4 < float((keep > 0).float().mean()) < 0.6


def test_rollout_matches_step_by_step(tiny):
    """The port's plain rollout, free running, against the reference's over
    the same memory, lengths and seeds: frames, stop logits and attention at
    every step; teacher forced on the port's frames, the reference gives
    the same again."""
    cfg, hp, model, sd, ids, dvec, seeds = tiny
    lengths = (ids != 0).sum(1)
    memory, pm = model.encode(ids, lengths, dvec)
    roll = t2_kernel.Rollout(model, 110)
    mel, gate, att, states = roll(memory, pm, lengths, seeds)
    want = ref.rollout(sd, memory, lengths, seeds, 110, hp)
    forced = ref.rollout(sd, memory, lengths, seeds, 110, hp, frames=mel)
    # from the port's state before step 100, the reference's steps 100-109
    resumed = ref.rollout(sd, memory, lengths, seeds, 10, hp, frames=mel, start=100,
                          state={k: v[4] for k, v in states.items() if k != "step"})
    assert states["step"].tolist() == [0, 25, 50, 75, 100] and not states["c_att"][0].any()
    for got, w, f in zip((mel, gate, att), want, forced):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) < 1e-4
        assert float((got - f).abs().max()) < 1e-4
    for got, r in zip((mel[:, 100:], gate[:, 100:], att[..., 100:]), resumed):
        assert float((got - r).abs().max()) < 1e-4
    assert float(att.sum(1).sub(1).abs().max()) < 1e-5
    # another seed, another prenet mask, another rollout
    other = t2_kernel.Rollout(model, 24)(memory, pm, lengths, seeds + 1)[0]
    assert float((other - mel[:, :24]).abs().max()) > 1e-3


def test_postnet_and_mel_to_linear(tiny):
    cfg, hp, model, sd, *_ = tiny
    mel = torch.randn(2, 24, 8, generator=torch.Generator().manual_seed(4))
    assert float((model.postnet_apply(mel) - ref.postnet(sd, mel, hp)).abs().max()) < 1e-5
    got = mel_to_linear(mel, mel_pseudo_inverse(cfg))
    want = ref.mel_to_linear(mel, hp)
    assert got.shape == (2, 24, 513)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_whole_call(tiny):
    """A call: the audio's shape, the postnet mel, attention and gate the
    reference's chain gives, each row's stop frame, and the audio the
    vocoder gives on the call's mel."""
    cfg, hp, model, sd, ids, dvec, seeds = tiny
    syn = Tacotron2Synthesizer(cfg, model)
    audio, mel, att = syn(ids.numpy(), dvec.numpy(), seeds)
    memory = ref.encoder(sd, ids, dvec, hp)
    frames, gate, att_ref = ref.rollout(sd, memory, ref.lengths_of(ids), seeds, 24, hp)
    post = ref.postnet(sd, frames, hp)
    assert audio.shape == (3, 256 * 23) and audio.device.type == "cpu"
    assert float((mel - post).abs().max()) < 1e-4
    assert float((att - att_ref).abs().max()) < 1e-4
    assert float((syn.gate - gate).abs().max()) < 1e-4
    assert torch.equal(syn.stop_frames(), ref.stop_frames(gate))
    # the audio is the vocoder's on the call's own mel (SPSI's peak picking
    # flips on ~1e-6 magnitude differences, so not on the reference's)
    assert torch.equal(audio, syn.vocode(mel, seeds))


def test_portbench_reference_is_a_byte_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    assert (root / "portbench/reference/tacotron2.py").read_bytes() == \
        (root / "plainref/tacotron2.py").read_bytes()


def test_cli_synthesize_and_spoof_set(tmp_path):
    """``cli.main synthesize`` and the spoof set (``generate_test_utterances``,
    no staging) build the Tacotron 2 synthesizer from a configuration of
    ``hparams.py`` keys and write each row up to its stop frame."""
    import json

    from spoofsv_torch.cli import generate_test_utterances
    from spoofsv_torch.cli import main as cli_main
    from spoofsv_torch.dsp import host as dsp_host

    texts = tmp_path / "havard.txt"
    texts.write_text("\n".join(TEXTS) + "\n")
    (tmp_path / "spk").mkdir()
    rng = np.random.default_rng(0)
    for name in ("p225", "p226"):
        (tmp_path / "wav22" / name).mkdir(parents=True)
        np.save(tmp_path / "spk" / f"{name}.npy", rng.standard_normal(8).astype(np.float32))
    conf = tmp_path / "t2.json"
    conf.write_text(json.dumps({**TINY, "learning_rate": 1e-3, "tts_texts": str(texts),
                                "spk_emb_dir": str(tmp_path / "spk"),
                                "data_root_dir": str(tmp_path), "src_root_dir": str(tmp_path)}))
    out = cli_main.main(["synthesize", "-C", str(conf), "-T", "run1"], device="cpu")
    wavs = sorted(p.name for p in (tmp_path / "samples" / "run1").glob("*.wav"))
    assert out == str(tmp_path / "samples" / "run1") and wavs == ["S1_B1.wav", "S2_B1.wav",
                                                                  "S3_B1.wav"]
    with pytest.raises(NotImplementedError):
        cli_main.main(["train_text2mel", "-C", str(conf), "-T", "run1"], device="cpu")
    generate_test_utterances.main(["-C", str(conf), "-T", "run2", "--skip_staging",
                                   "--eval_utt_num", "2"], device="cpu")
    spoof = tmp_path / "test" / "run2" / "spoof_data"
    assert sorted(p.name for p in spoof.iterdir()) == ["s225", "s226"]
    y, sr = dsp_host.load_wav(str(spoof / "s225" / "s225_001.wav"))
    assert sr == 22050 and 0 < len(y) <= 256 * 24
