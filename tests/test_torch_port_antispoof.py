"""The port's anti-spoofing countermeasure against the JAX package's, on the CPU.

Same seeded numpy inputs and the same weights (flax parameters carried over
by ``export_critic`` / ``export_drs``) on both sides, f32:

* ``ASVspoofSource`` features (mel and lin) and ``batches``: equal arrays
  (both compute on the host in numpy from the same files);
* the CM forward (v1/v2 × mel/lin, ``disc_dim`` 16) deterministic: within 1e-5;
* 5 training steps against ``make_cm_train_step`` (optax AMSGrad + decayed
  weights) with dropout off (the rate set to 0 on both sides; dropout masks
  cannot match): losses and parameters within 1e-5 at every step, and a
  ``torch.optim.Adam(amsgrad=True)`` run that parts from optax (the reason
  the port writes the update out);
* the loss on clipped and floored predictions, ``cm_eer`` and
  ``write_cm_scores`` (byte-equal files);
* a JAX-written checkpoint scored by the port's CLI ``dev`` (scores within
  1e-5 of the JAX CLI's), a port-written one read by the JAX CLI's loader;
* ``ResBasicBlock`` and ``DRS`` in eval and train mode at a small shape
  (40 × 48, both conv paddings): outputs within 1e-4, updated running
  statistics within 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.cli import antispoof as jcli
from spoofsv_tpu.config import load_config as jload_config
from spoofsv_tpu.models import discriminator as jdisc
from spoofsv_tpu.spoofkit import antispoof as jas
from spoofsv_tpu.utils.torch_export import export_critic as jexport_critic
from spoofsv_torch.cli import antispoof as cli
from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host
from spoofsv_torch.export import export_critic, export_drs
from spoofsv_torch.models.discriminator import DRS, Critic1D, ResBasicBlock
from spoofsv_torch.spoofkit import antispoof as pas
from spoofsv_torch.weights import (critic_flax_arrays, load_critic_params, load_drs_from_jax,
                                   load_state)

DISC = 16


def _tone(rng, sr, seconds, pitch):
    t = np.arange(int(sr * seconds)) / sr
    y = sum(np.sin(2 * np.pi * pitch * k * t + rng.uniform(0, 6)) / k for k in range(1, 5))
    return (0.3 * y / 2.0 + 0.01 * rng.normal(size=t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A TTS train list of 6 wavs (22.05 kHz: the source resamples) and an
    anti-spoofing tree with 3 train spoofs (FLAC) and 4 staged dev spoofs
    (2 FLAC, 2 wav), as the protocol files name them."""
    root = tmp_path_factory.mktemp("cm")
    rng = np.random.default_rng(0)
    os.makedirs(root / "data" / "data_path" / "ordinary")
    wavs = []
    for i in range(6):
        p = str(root / f"utt{i}.wav")
        host.write_wav(p, _tone(rng, 22050, 0.6 + 0.15 * i, 180 + 25 * i), 22050)
        wavs.append(p)
    (root / "data" / "data_path" / "ordinary" / "wav.path.train").write_text("\n".join(wavs) + "\n")
    cm = root / "cm"
    proto = cm / "ASVspoof2019_LA_cm_protocols"
    os.makedirs(proto)
    for mid, names, proto_name in (
            ("ASVspoof2019_LA_train", ["LA_T_0000001", "LA_T_0000002", "LA_T_0000003"],
             "ASVspoof2019.LA.cm.train.trn.txt"),
            ("t", ["LA_D_0000001", "LA_D_0000002", "LA_D_0000003", "LA_D_0000004"],
             "customized_data_t.txt")):
        os.makedirs(cm / mid / "flac")
        lines = []
        for j, name in enumerate(names):
            y = _tone(rng, 16000, 0.5 + 0.2 * j, 300 + 40 * j)
            if mid == "t" and j % 2:
                host.write_wav(str(cm / mid / "flac" / f"{name}.wav"), y, 16000)
            else:
                host.write_flac(str(cm / mid / "flac" / f"{name}.flac"), y, 16000)
            lines.append(f"LA_0001 {name} - - spoof")
        lines.append("LA_0001 LA_T_9999999 - - bonafide")
        (proto / proto_name).write_text("\n".join(lines) + "\n")
    cfg = Config(data_root_dir=str(root / "data") + "/", src_root_dir=str(root) + "/",
                 antispoof_dir=str(cm), disc_dim=DISC)
    conf = str(root / "config.json")
    with open(conf, "w") as f:
        json.dump(cfg.to_reference_dict(), f)
    return root, cfg, conf


@pytest.mark.parametrize("step", ["train", "dev"])
def test_source_and_batches_equal_jax(tree, step):
    root, cfg, conf = tree
    src = pas.ASVspoofSource(cfg, step, "t", bonafide_cap=4, cache_dir=None)
    jsrc = jas.ASVspoofSource(jload_config(conf), step, "t", bonafide_cap=4, cache_dir=None)
    assert src.files == jsrc.files and len(src) == (7 if step == "train" else 6)
    np.testing.assert_array_equal(src.labels, jsrc.labels)
    for i in range(len(src)):
        for a, b in zip(src[i], jsrc[i]):
            np.testing.assert_array_equal(a, b)
    for feat in ("mel", "lin"):
        got = list(pas.batches(src, 3, cfg.tpu.bucket_frames, True, seed=2, feat=feat))
        want = list(jas.batches(jsrc, 3, cfg.tpu.bucket_frames, True, seed=2, feat=feat))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_feature_cache_round_trip(tree):
    root, cfg, _ = tree
    cache = str(root / "cm_spec_test")
    src = pas.ASVspoofSource(cfg, "train", "t", bonafide_cap=4, cache_dir=cache)
    src.warm_cache("mel", workers=2)
    assert len(os.listdir(cache)) == len(src)
    plain = pas.ASVspoofSource(cfg, "train", "t", bonafide_cap=4, cache_dir=None)
    for i in range(len(src)):
        np.testing.assert_array_equal(src.get(i, "mel")[0], plain.get(i, "mel")[0])
    with pytest.raises(ValueError):
        src.get(0, "mfcc")


def _flax_cm(variant, feat, in_dim, rate=0.05):
    pool2 = None if variant == "v1" else (2 if feat == "mel" else 4)
    pool1 = 2 if variant == "v1" else (4 if feat == "mel" else 8)
    model = jdisc.Critic1D(disc_dim=DISC, pool1=pool1, pool2=pool2,
                           mid_dim=4 if feat == "mel" else 8, extra_stage=(variant == "v2"),
                           sigmoid_out=True, dropout_rate=rate)
    x = np.random.default_rng(3).uniform(0, 1, (4, 80, in_dim)).astype(np.float32)
    return model, model.init(jax.random.PRNGKey(1), jnp.asarray(x)), x


@pytest.mark.parametrize("variant", [None, "v1", "v2"])
@pytest.mark.parametrize("feat", ["mel", "lin"])
def test_cm_forward_matches_flax(tree, variant, feat):
    _, cfg, _ = tree
    in_dim = 80 if feat == "mel" else 513
    jm, params, x = _flax_cm(variant, feat, in_dim)
    port = load_state(cli.build_cm(cfg, variant, feat), export_critic(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(x))), atol=1e-5)
    if variant != "v2":
        # the JAX exporter's keys are the port's where it has the layers
        want = jexport_critic(params)
        assert sorted(want) == sorted(export_critic(params))
    flat = critic_flax_arrays(port)
    assert sorted(flat) == sorted(
        "/".join(str(getattr(k, "key", k)) for k in p)
        for p, _ in jax.tree_util.tree_leaves_with_path(params))


def test_amsgrad_steps_match_optax(tree):
    """5 steps of the CM step from the same weights on the same batches,
    dropout off on both sides: losses and every parameter within 1e-5. The
    gradients' scale drops over the steps, so the running maximum of the
    bias-corrected second moment is held from an earlier step, which is
    where ``torch.optim.Adam(amsgrad=True)`` parts from optax."""
    _, cfg, _ = tree
    jm, params, _ = _flax_cm(None, "mel", 80, rate=0.0)
    init_fn, step_fn, _ = jas.make_cm_train_step(jm)
    port = load_state(cli.build_cm(cfg, None, "mel"), export_critic(params))
    port.dropout_rate = 0.0
    ref = load_state(cli.build_cm(cfg, None, "mel"), export_critic(params))
    step, _, opt = pas.make_cm_train_step(port)
    adam = torch.optim.Adam(ref.parameters(), lr=1e-3, betas=(0.9, 0.98), eps=1e-9,
                            weight_decay=1e-4, amsgrad=True)
    rng = np.random.default_rng(5)
    _, opt_state = init_fn(jax.random.PRNGKey(0), jnp.zeros((1, 80, 80)))
    key = jax.random.PRNGKey(0)
    for i in range(5):
        x = rng.uniform(0, 1, (6, 80, 80)).astype(np.float32) * (0.2 ** i)
        lab = (rng.uniform(size=6) > 0.5).astype(np.float32)
        key, sub = jax.random.split(key)
        params, opt_state, jloss = step_fn(params, opt_state, jnp.asarray(x), jnp.asarray(lab),
                                           sub)
        loss = step(torch.from_numpy(x), torch.from_numpy(lab))
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
        want = export_critic(params)
        for k, v in port.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, err_msg=f"step {i} {k}")
        adam.zero_grad()
        pas.cm_loss(ref(torch.from_numpy(x)), torch.from_numpy(lab)).backward()
        adam.step()
    assert opt.count == 5
    gap = max(float((a - b).detach().abs().max()) for a, b in zip(ref.parameters(), port.parameters()))
    assert gap > 1e-4, gap


def test_dropout_draws_from_the_steps_generator(tree):
    _, cfg, _ = tree
    torch.manual_seed(0)
    m = cli.build_cm(cfg, None, "mel")
    x = torch.rand(2, 80, 80)
    a = m(x, deterministic=False, generator=torch.Generator().manual_seed(3))
    b = m(x, deterministic=False, generator=torch.Generator().manual_seed(3))
    c = m(x, deterministic=False, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(m(x), m(x, deterministic=True))


def test_loss_eer_and_score_file_equal_jax(tmp_path):
    pred = np.asarray([0.0, 1.0, 1.2, -0.1, 0.3, 0.999999], np.float32)
    lab = np.asarray([1, 0, 1, 0, 1, 0], np.float32)
    p, y = jnp.clip(jnp.asarray(pred), 0.0, 1.0), jnp.asarray(lab)
    want = jnp.mean(-y * jnp.log(jnp.maximum(p, 1e-6)) - (1 - y) * jnp.log(jnp.maximum(1 - p,
                                                                                     1e-6)))
    got = pas.cm_loss(torch.from_numpy(pred), torch.from_numpy(lab))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    rng = np.random.default_rng(7)
    labels = (rng.uniform(size=40) > 0.4).astype(np.float32)
    scores = rng.normal(size=40) + labels
    assert pas.cm_eer(labels, scores) == jas.cm_eer(labels, scores)
    rows = [(int(i), float(labels[i]), float(scores[i])) for i in range(40)]
    a = pas.write_cm_scores(rows, "x", str(tmp_path / "port"))
    b = jas.write_cm_scores(rows, "x", str(tmp_path / "jax"))
    assert open(a).read() == open(b).read()


def _score_lines(path):
    rows = [ln.split() for ln in open(path).read().splitlines()]
    return [r[:3] for r in rows], np.asarray([float(r[3]) for r in rows])


def test_checkpoints_cross_between_the_clis(tree, tmp_path, monkeypatch, capsys):
    """The JAX CLI trains 2 iterations and writes ``final.npz``; the port's
    CLI ``dev`` scores with it as the JAX CLI does. Then the port's CLI
    trains and writes its own, which the JAX CLI's loader reads and scores
    with as the port does."""
    root, cfg, conf = tree
    monkeypatch.chdir(tmp_path)
    jcli.main(["train", "-C", conf, "-T", "t", "--max_iterations", "2", "--bonafide_cap", "4"])
    ck = str(tmp_path / "checkpoints" / "t" / "final.npz")
    jcli.main(["dev", "-C", conf, "-T", "t", "-R", ck, "--bonafide_cap", "4"])
    want = _score_lines(tmp_path / "cm_scores" / "scores_t.txt")
    path, eer, _ = cli.main(["dev", "-C", conf, "-T", "t", "-R", ck, "--bonafide_cap", "4"],
                            device="cpu")
    got = _score_lines(path)
    assert got[0] == want[0] and len(got[0]) == 6
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert "CM EER" in capsys.readouterr().out

    model = cli.main(["train", "-C", conf, "-T", "p", "--max_iterations", "3",
                      "--save_interval", "2", "--bonafide_cap", "4", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "checkpoints" / "p")) == ["2_iteration.npz", "final.npz"]
    pk = str(tmp_path / "checkpoints" / "p" / "final.npz")
    params = jcli._load(pk)
    back = load_critic_params(pk, cli.build_cm(cfg, None, "mel"))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    x = np.random.default_rng(9).uniform(0, 1, (3, 80, 80)).astype(np.float32)
    jm = jdisc.Critic1D(disc_dim=DISC, pool1=4, pool2=2, mid_dim=4, sigmoid_out=True)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(params, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("variant,feat", [("v1", "mel"), ("v2", "lin")])
def test_cli_variants_train(tree, tmp_path, monkeypatch, variant, feat):
    _, cfg, conf = tree
    monkeypatch.chdir(tmp_path)
    model = cli.main(["train", "-C", conf, "-T", "v", "--variant", variant, "--feat", feat,
                      "--max_iterations", "1", "--bonafide_cap", "4"], device="cpu")
    assert (model.conv1.weight.shape[1] == (80 if feat == "mel" else 513)
            and hasattr(model, "conv3_2") == (variant == "v2"))
    back = load_critic_params(str(tmp_path / "checkpoints" / "v" / "final.npz"),
                              cli.build_cm(cfg, variant, feat))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ----------------------------------------------------------------------
# ResBasicBlock and DRS
# ----------------------------------------------------------------------

def _batch_stats_close(port, stats, prefix=""):
    for name, node in stats.items():
        if "mean" in node:
            bn = port.get_submodule(f"{prefix}{name}")
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(node["mean"]),
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(node["var"]),
                                       atol=1e-5, err_msg=name)
        else:
            _batch_stats_close(port, node, f"{prefix}{name}.")


def test_res_basic_block_matches_flax():
    x = np.random.default_rng(0).normal(size=(2, 6, 7, 8)).astype(np.float32)
    jb = jdisc.ResBasicBlock(8)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial running statistics, so eval mode reads them
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype) / v.size, variables["batch_stats"])}
    sd = {}
    for bn in ("bn1", "bn2"):
        p, s = variables["params"][bn], variables["batch_stats"][bn]
        sd.update({f"{bn}.weight": p["scale"], f"{bn}.bias": p["bias"],
                   f"{bn}.running_mean": s["mean"], f"{bn}.running_var": s["var"],
                   f"{bn}.num_batches_tracked": np.zeros((), np.int64)})
    for conv in ("cnn1", "cnn2"):
        sd[f"{conv}.weight"] = np.transpose(np.asarray(variables["params"][conv]["kernel"]),
                                            (3, 2, 0, 1))
    port = load_state(ResBasicBlock(8), sd).eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply(variables, jnp.asarray(x))), atol=1e-4)
    want, upd = jb.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    _batch_stats_close(port, upd["batch_stats"])


@pytest.mark.parametrize("focal", [False, True])
def test_drs_matches_flax(focal):
    """40 × 48: cnn1 takes the VALID path, cnn2-cnn4 the SAME one."""
    x = np.random.default_rng(1).normal(size=(3, 40, 48, 1)).astype(np.float32)
    jm = jdisc.DRS(num_classes=2, resnet_blocks=1, focal_loss=focal)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = load_drs_from_jax(DRS((40, 48), focal_loss=focal), variables).eval()
    assert port.pads == [(0, 0), (4, 4), (8, 8), (9, 6)]
    assert sorted(export_drs(variables)) == sorted(port.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, jnp.asarray(x))), atol=1e-4)
    if not focal:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    want, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    _batch_stats_close(port, upd["batch_stats"])


def test_critic_in_dim_and_init():
    m = Critic1D(513, disc_dim=DISC, pool1=8, pool2=4, mid_dim=8, sigmoid_out=True)
    y = m(torch.rand(2, 80, 513))
    assert y.shape == (2,) and bool(((y > 0) & (y < 1)).all())
