"""The frozen reference computes the function the port computes: on CPU
tensors, at a tiny size, from the same seeded weights (the port's plain
paths, which its CUDA kernels are held against on the card)."""

import io

import numpy as np
import pytest
import torch

from portbench import harness, inputs, program
from portbench.reference import dctts, train as ref_train, vocoder
from portbench.tests.conftest import TINY


def _tiny_conf(name="dctts-vctk"):
    c = harness.config(name)
    c["config"].update(TINY)
    return c


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    conf = _tiny_conf()
    melsyn, ssrn, sd_t2m, sd_ssrn = program.build_generators(conf, 11, torch.device("cpu"),
                                                             torch.float32)
    return conf, melsyn.eval(), ssrn.eval(), sd_t2m, sd_ssrn


def _inputs(conf, B=3, seed=4):
    rng = np.random.default_rng(seed)
    ids = inputs.encode(inputs.sentences(B), conf["config"]["VOCABULARY"])
    spk = rng.standard_normal((B, conf["config"]["SPK_EMB_DIM"])).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(spk)


@pytest.mark.parametrize("name", ["dctts-vctk", "dctts-vctk-refgl64"])
def test_schema_is_the_ports_state_dict(name):
    from spoofsv_torch.models import SSRN, MelSyn

    conf = harness.config(name)
    cfg = program.port_config(conf)
    dims = dctts.dims_of(conf)
    with torch.device("meta"):
        melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                        cfg.mel.freq_bins, cfg.hidden_dim)
        ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
    for module, schema in ((melsyn, dctts.melsyn_schema(dims)), (ssrn, dctts.ssrn_schema(dims))):
        assert [(k, tuple(v.shape)) for k, v in module.state_dict().items()] == schema


def test_decode_teacher_forced_follows_the_ports_rollout(models):
    from spoofsv_torch.infer.decode import make_decoder

    conf, melsyn, _, sd, _ = models
    ids, spk = _inputs(conf)
    mel, att, _ = make_decoder(melsyn, 30)(ids, spk)
    y, a = dctts.decode_teacher_forced(sd, ids, spk, mel, att)
    assert float((y - mel).abs().max()) < 2e-5
    assert float((a - att).abs().max()) < 2e-5
    # a frame altered after the fact is seen at that frame
    bad = mel.clone()
    bad[1, 12] += 0.2
    y, _ = dctts.decode_teacher_forced(sd, ids, spk, bad, att)
    assert float((y - bad)[1, 12].abs().max()) > 0.1


def test_text2mel_forward_and_ssrn(models):
    conf, melsyn, ssrn, sd_t2m, sd_ssrn = models
    ids, spk = _inputs(conf)
    mel = torch.rand(3, 20, 80)
    with torch.no_grad():
        y_p, a_p = melsyn(ref_train.shift_right(mel), ids, spk)
        lin_p = ssrn(mel)
    y, a = dctts.text2mel_forward(sd_t2m, ref_train.shift_right(mel), ids, spk)
    assert float((y - y_p).abs().max()) < 2e-5 and float((a - a_p).abs().max()) < 2e-5
    assert float((dctts.ssrn(sd_ssrn, mel) - lin_p).abs().max()) < 2e-5


@pytest.mark.parametrize("mode", ["spsi", "random", "advance"])
@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (4, 5e-4)])
def test_griffin_lim_each_init(mode, iters, tol):
    """One iteration agrees to f32 rounding; the momentum (0.99) amplifies
    the two overlap-adds' different rounding over later iterations (5.8e-5
    after four, measured), so four are held at 5e-4."""
    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.ops.gl_kernel import init_angles_plain

    g = torch.Generator().manual_seed(1)
    spec = torch.rand(2, 40, 513, generator=g) ** 2
    seeds = torch.tensor([7, 2 ** 31 - 2], dtype=torch.int32)
    want = torchdsp.griffin_lim(spec, 1024, 256, 1024, iters,
                                init_angles=init_angles_plain(spec, 1024, 256, mode, seeds))
    got = vocoder.griffin_lim(spec, vocoder.init_angles(spec, mode, 1024, 256, seeds), 1024, 256,
                              iters)
    assert float((got - want).norm() / want.norm()) < tol
    ded = vocoder.deemphasis(got.numpy(), 0.97)
    assert np.abs(ded - torchdsp.deemphasis(got).numpy()).max() < 1e-4 * np.abs(ded).max()


def test_reply_samples_are_the_ports():
    from scipy.io import wavfile

    from spoofsv_torch.config import Config
    from spoofsv_torch.infer.synthesize import finalize_audio
    from spoofsv_torch.serve import pcm16, wav_bytes

    g = torch.Generator().manual_seed(2)
    audio = torch.randn(3, 20000, generator=g) * torch.linspace(0, 1, 20000) ** 4
    want = []
    for row in pcm16(audio).numpy():
        y = finalize_audio(row.astype(np.float32) / 32767.0, Config(), trim_db=30.0)
        want.append(wavfile.read(io.BytesIO(wav_bytes(y, 22050)))[1])
    got = vocoder.pcm16_wav_samples(audio, 30.0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_training_steps_are_the_ports(models):
    from spoofsv_torch.config import Config
    from spoofsv_torch.train.steps import make_ordinary_step

    conf, _, _, _, _ = models
    melsyn, sd = program.build_generators(conf, 12, torch.device("cpu"), torch.float32,
                                          train=True)
    sd0 = {k: v.clone() for k, v in sd.items()}
    ids, spk = _inputs(conf)
    g = torch.Generator().manual_seed(3)
    batches = [{"mel": torch.rand(3, 16, 80, generator=g), "text": ids, "spk": spk}
               for _ in range(3)]
    cfg = Config()
    init, step = make_ordinary_step(melsyn, cfg, "train_text2mel")
    state = init()
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    adam = {"alpha": cfg.adam.alpha, "beta_1": cfg.adam.beta_1, "beta_2": cfg.adam.beta_2,
            "epsilon": cfg.adam.epsilon}
    gaw = torch.from_numpy(ref_train.guided_attention(cfg.max_text_len, cfg.max_frame_num))
    ref_losses, _, params = ref_train.run_steps(sd0, batches, adam, gaw)
    assert np.allclose(losses, ref_losses, rtol=1e-5)
    for k, p in melsyn.named_parameters():
        assert float((p.detach() - params[k]).abs().max()) < 1e-5, k
