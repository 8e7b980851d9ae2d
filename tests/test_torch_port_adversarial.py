"""The port's critics and adversarial training vs the JAX package on the CPU.

JAX-initialised parameters reach the port through the reference schema
(``export_*`` then ``load_state``); seeded numpy batches go to both sides.
Tolerances: critic forwards rtol 1e-5 (f32, a few hundred terms a sum);
step metrics rtol 1e-5, the gradient penalty rtol 1e-4 (a norm of a second
derivative); parameters after the G, D, D sequence atol 2e-5, since Adam's
first steps move a parameter by about lr·sign(g), so a gradient differing by
rounding moves it by rounding times lr (``test_torch_port_train.py``'s gate).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.cli.main import build_models as jax_build_models
from spoofsv_tpu.models.discriminator import Critic1D as JCritic1D
from spoofsv_tpu.models.discriminator import LinDisc as JLinDisc
from spoofsv_tpu.models.discriminator import MelDisc as JMelDisc
from spoofsv_tpu.train.steps import make_adversarial_steps as jax_adversarial_steps
from spoofsv_tpu.utils import torch_export as jexport
from spoofsv_torch import export
from spoofsv_torch.cli import main as cli
from spoofsv_torch.models import Critic1D, LinDisc, MelDisc, layers
from spoofsv_torch.ops import gate_kernel, hconv_kernel
from spoofsv_torch.train import (AdvTrainState, Trainer, clip_weights, make_adversarial_steps,
                                 make_fused_adversarial_step, steps)
from spoofsv_torch.weights import load_critic_from_jax, load_reference_checkpoint, load_state

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

KINDS = ("train_text2mel", "train_ssrn")
GAN_TYPES = ("wgan-gp", "wgan", "vanilla")
GEN_EXPORT = {"train_text2mel": jexport.export_melsyn, "train_ssrn": jexport.export_ssrn}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.uniform(0.05, 0.95, (b, 12, cfg.mel.freq_bins)).astype(np.float32),
        "text": rng.integers(1, cfg.vocab_len - 1, (b, 16)).astype(np.int32),
        "spk": rng.normal(size=(b, cfg.spk_emb_dim)).astype(np.float32),
        "lin": rng.uniform(0.05, 0.95, (b, 48, cfg.lin_bins)).astype(np.float32),
    }


def _critic_state(params, extra_stage: bool):
    """``export_critic`` plus the extra stage's layers, which it does not name."""
    sd = export.export_critic(params)
    if extra_stage:
        p = params["params"]
        export._undense(sd, p["conv3_2"], "conv3_2")
        export._unln(sd, p["ln3_2"], "ln3_2")
    return sd


# ---------------------------------------------------------------------------
# Critics
# ---------------------------------------------------------------------------

CRITICS = {
    "mel": (lambda c: JMelDisc(disc_dim=c), lambda c: MelDisc(c), 80, 24),
    "lin": (lambda c: JLinDisc(disc_dim=c), lambda c: LinDisc(c), 513, 70),
    "mel_sigmoid": (lambda c: JMelDisc(disc_dim=c, sigmoid_out=True),
                    lambda c: MelDisc(c, sigmoid_out=True), 80, 17),
    "no_pool2": (lambda c: JCritic1D(disc_dim=c, pool1=4, pool2=None, mid_dim=4),
                 lambda c: Critic1D(80, c, pool1=4, pool2=None, mid_dim=4), 80, 13),
    "extra_stage": (lambda c: JCritic1D(disc_dim=c, pool1=8, pool2=4, mid_dim=8,
                                        extra_stage=True),
                    lambda c: Critic1D(513, c, pool1=8, pool2=4, mid_dim=8, extra_stage=True),
                    513, 77),
}


@pytest.mark.parametrize("name", sorted(CRITICS))
def test_critic_forward_matches_flax(name):
    """Pools with floor semantics on ragged lengths (24, 70, 17, 13, 77
    frames), LeakyReLU 0.05, the sigmoid and pool variants."""
    jmake, tmake, bins, T = CRITICS[name]
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (3, T, bins)).astype(np.float32)
    jc = jmake(16)
    params = jc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    extra = name == "extra_stage"
    if not extra:
        sd = export.export_critic(params)
        ref_sd = jexport.export_critic(params)
        assert sorted(sd) == sorted(ref_sd)
        for k, v in ref_sd.items():
            np.testing.assert_array_equal(sd[k], v, err_msg=k)
    critic = load_state(tmake(16), _critic_state(params, extra))
    ref = np.asarray(jc.apply(params, jnp.asarray(x)))
    got = critic(_t(x))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    if name == "mel_sigmoid":
        assert ((got > 0) & (got < 1)).all()


def test_critic_dropout_only_when_not_deterministic():
    """The default forward is deterministic (the JAX default, which the JAX
    steps never override), whatever the module's training flag."""
    torch.manual_seed(0)
    critic = MelDisc(16).train()
    x = torch.rand(2, 24, 80)
    assert torch.equal(critic(x), critic(x))
    assert not torch.equal(critic(x, deterministic=False), critic(x))


def test_critic_highway_block_is_pinned_to_xla():
    critic = LinDisc(16)
    assert critic.hc.gate_impl == "xla"
    with pytest.raises(ValueError, match="highway impl"):
        layers.HighwayConv(16, gate_impl="bogus")


# ---------------------------------------------------------------------------
# Adversarial steps: G, D, D against make_adversarial_steps
# ---------------------------------------------------------------------------

def _jax_critics(cfg, gan_type):
    if gan_type == "vanilla":
        return (JMelDisc(disc_dim=cfg.disc_dim, sigmoid_out=True),
                JLinDisc(disc_dim=cfg.disc_dim, sigmoid_out=True))
    return JMelDisc(disc_dim=cfg.disc_dim), JLinDisc(disc_dim=cfg.disc_dim)


def _port_critic(cfg, kind, gan_type):
    sig = gan_type == "vanilla"
    if kind == "train_text2mel":
        return MelDisc(cfg.disc_dim, sigmoid_out=sig, freq_bins=cfg.mel.freq_bins)
    return LinDisc(cfg.disc_dim, sigmoid_out=sig, lin_bins=cfg.lin_bins)


@pytest.fixture(scope="module")
def jax_sequences(tiny_cfg):
    """Per (gan_type, train kind): the exported initial generator and critic,
    the metrics of a G, D, D sequence, JAX's penalty draws for the two D
    steps, and the exported parameters after the sequence."""
    batch = _batch(tiny_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    melsyn, ssrn, _, _ = jax_build_models(tiny_cfg, "conditional")
    out = {}
    for gan_type in GAN_TYPES:
        for kind, gen, disc in zip(KINDS, (melsyn, ssrn), _jax_critics(tiny_cfg, gan_type)):
            init_fn, g_step, d_step = jax_adversarial_steps(gen, disc, tiny_cfg, kind, gan_type)
            state = init_fn(jax.random.PRNGKey(0), jbatch)
            init = (GEN_EXPORT[kind](state.gen_params), jexport.export_critic(state.disc_params))
            metrics, draws = [], []
            state, m = g_step(state, jbatch, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
            for seed in (2, 3):
                key = jax.random.PRNGKey(seed)
                # d_step's own draw: the second half of its key's split
                draws.append(np.asarray(jax.random.uniform(jax.random.split(key)[1], (2, 1, 1),
                                                           jnp.float32)))
                state, m = d_step(state, jbatch, key)
                metrics.append({k: float(v) for k, v in m.items()})
            final = (GEN_EXPORT[kind](state.gen_params), jexport.export_critic(state.disc_params))
            out[gan_type, kind] = dict(init=init, metrics=metrics, draws=draws, final=final)
    return batch, out


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused_pair"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_adversarial_steps_match_jax(tiny_cfg, jax_sequences, monkeypatch, gan_type, kind, impl):
    """Every metric of the G, D, D sequence and both nets' parameters after
    it, under every highway impl of the generator: the critic is pinned to
    "xla", so under "pallas" and "fused_pair" the penalty's second-order
    terms are all there (with the kernels' once-differentiable backwards a
    critic that followed the process-wide impl would raise)."""
    batch, ref = jax_sequences
    ref = ref[gan_type, kind]
    gen = cli.build_models(tiny_cfg, device="cpu")[0 if kind == "train_text2mel" else 1]
    load_state(gen, ref["init"][0])
    disc = load_state(_port_critic(tiny_cfg, kind, gan_type), ref["init"][1])
    draws = iter(ref["draws"])
    monkeypatch.setattr(steps, "draw_mixing", lambda b, g, d: _t(next(draws)).to(d))
    tb = {k: _t(v) for k, v in batch.items()}
    with layers.gate_impl(impl):
        init_fn, g_step, d_step = make_adversarial_steps(gen, disc, tiny_cfg, kind, gan_type)
        state = init_fn()
        got = []
        state, m = g_step(state, tb)
        got.append(m)
        for _ in range(2):
            state, m = d_step(state, tb, torch.Generator().manual_seed(0))
            got.append(m)
    assert state.step == 3
    for i, (want, have) in enumerate(zip(ref["metrics"], got)):
        assert sorted(have) == sorted(want), (i, sorted(have), sorted(want))
        for k, v in want.items():
            np.testing.assert_allclose(float(have[k]), v, rtol=1e-4 if k == "gp" else 1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    for module, final in zip((gen, disc), ref["final"]):
        sd = module.state_dict()
        assert sorted(sd) == sorted(final)
        for k, v in final.items():
            np.testing.assert_allclose(sd[k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
    if gan_type == "wgan":
        for k, v in disc.state_dict().items():
            if k.endswith(".weight"):
                assert bool((v.abs() <= 0.1).all()), k   # 0.1 in f32


def test_draw_mixing_uses_the_generator():
    a = steps.draw_mixing(4, torch.Generator().manual_seed(5), "cpu")
    b = steps.draw_mixing(4, torch.Generator().manual_seed(5), "cpu")
    assert a.shape == (4, 1, 1) and torch.equal(a, b) and ((a >= 0) & (a < 1)).all()


FUNCTIONS = {
    "gate": (lambda x, p: gate_kernel.fused_highway_gate(
        torch.cat([x, x * 0.5], -1), x, *p[2:]), 8),
    "conv": (lambda x, p: hconv_kernel.fused_highway_conv(x, *p, 1, False), 8),
    "pair": (lambda x, p: hconv_kernel.fused_highway_conv_pair(x, *p, *p, 1, 3, False), 8),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_double_backward_through_a_kernel_raises(name):
    """K4-K6's backwards are first-order: a gradient penalty through them
    raises instead of dropping its second-order terms."""
    fn, c = FUNCTIONS[name]
    rng = np.random.default_rng(0)
    p = [_t(rng.normal(size=(2 * c, c, 3)).astype(np.float32) * 0.1).requires_grad_(),
         _t(np.zeros(2 * c, np.float32)).requires_grad_(),
         *(_t(rng.normal(1.0, 0.1, c).astype(np.float32)).requires_grad_() for _ in range(4))]
    x = _t(rng.normal(size=(2, 10, c)).astype(np.float32)).requires_grad_()
    out = fn(x, p)
    g1, = torch.autograd.grad(out.sum(), x, retain_graph=True)   # a first derivative flows
    assert torch.isfinite(g1).all()
    g, = torch.autograd.grad(out.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.square().sum().backward()


def test_weight_clip_leaves_biases_alone():
    disc = MelDisc(16)
    with torch.no_grad():
        for p in disc.parameters():
            p.fill_(0.5)
    clip_weights(disc)
    for name, p in disc.named_parameters():
        want = 0.1 if name.endswith(".weight") else 0.5
        assert torch.all(p == want), name
    assert any(n.endswith(".bias") for n, _ in disc.named_parameters())


def test_fused_step_picks_by_step_and_pads_metrics(tiny_cfg):
    cfg = tiny_cfg.replace(ratio=2)
    torch.manual_seed(0)
    gen = cli.build_models(cfg, device="cpu")[0]
    init_fn, step = make_fused_adversarial_step(gen, MelDisc(cfg.disc_dim), cfg,
                                                "train_text2mel")
    state = init_fn()
    tb = {k: _t(v) for k, v in _batch(cfg).items()}
    kinds = []
    for _ in range(6):
        state, m = step(state, tb, torch.Generator().manual_seed(1))
        assert list(m) == list(steps.FUSED_METRICS)
        assert all(torch.isfinite(v) for v in m.values())
        kinds.append("G" if float(m["loss_disc"]) != 0.0 else "D")
    assert kinds == ["G", "D", "D", "G", "D", "D"] and state.step == 6


# ---------------------------------------------------------------------------
# Trainer: alternation, loss logs, checkpoints, resume
# ---------------------------------------------------------------------------

def test_g_d_alternation_and_logs(tiny_cfg, tmp_path):
    """tests/test_trainer_loop.py::test_g_d_alternation_and_logs on the port:
    ratio 2 over 6 iterations is G D D G D D."""
    cfg = tiny_cfg.replace(src_root_dir=str(tmp_path) + "/", ratio=2)
    torch.manual_seed(0)
    trainer = Trainer(cfg, cli.build_models(cfg, device="cpu")[0], "train_text2mel",
                      adversarial=True, disc_model=MelDisc(8), ctime="t3",
                      validate_with_decode=False)
    data = [_batch(cfg, s) for s in range(3)]
    seen = []
    for b in data * 2:
        if trainer.state is None:
            trainer.init()
        seen.append(trainer.train_iteration(trainer._place_batch(b)))
    trainer.close()
    assert [len(v) for v in (trainer.loss_logs["t_s"], trainer.loss_logs["t_s_o"],
                             trainer.loss_logs["t_d"], trainer.loss_logs["wd"])] == [2, 2, 4, 4]
    # the fused step's padded metrics: each branch's own keys set, the other's 0
    # (the G loss itself may be 0: recon·(1 − 1) when the critic's term is negative)
    assert all(list(m) == list(steps.FUSED_METRICS) for m in seen)
    g_keys, d_keys = ("l1", "bd", "att", "loss_disc"), ("loss_d", "wd", "gp")
    kinds = ["G" if all(m[k] != 0 for k in g_keys) and all(m[k] == 0 for k in d_keys)
             else "D" if all(m[k] != 0 for k in d_keys)
             and all(m[k] == 0 for k in (*g_keys, "loss")) else "?" for m in seen]
    assert kinds == ["G", "D", "D"] * 2
    assert trainer.loss_logs["t_s"] == [seen[0]["loss"], seen[3]["loss"]]
    assert trainer.loss_logs["t_d"] == [m["loss_d"] for m, k in zip(seen, kinds) if k == "D"]
    assert isinstance(trainer.state, AdvTrainState) and trainer.state.step == 6


def _opt_equal(a: dict, b: dict) -> bool:
    if a["param_groups"] != b["param_groups"] or sorted(a["state"]) != sorted(b["state"]):
        return False
    return all(torch.equal(torch.as_tensor(a["state"][i][k]), torch.as_tensor(b["state"][i][k]))
               for i in a["state"] for k in a["state"][i])


@pytest.mark.parametrize("kind", KINDS)
def test_adversarial_checkpoint_reload_and_resume(tiny_cfg, tmp_path, kind):
    """The reference keys plus the critic, its Adam and the loss logs; the
    critic reloads through ``load_reference_checkpoint(key="disc_state_dict")``;
    ``resume`` restores both nets, both Adam states, the counters and the logs
    exactly as saved, then trains on."""
    cfg = tiny_cfg.replace(src_root_dir=str(tmp_path) + "/", val_every_iter=2, ratio=2)
    pick = 0 if kind == "train_text2mel" else 1
    torch.manual_seed(0)
    models = cli.build_models(cfg, device="cpu")
    gen, disc = models[pick], models[2 + pick]
    data = [_batch(cfg, s) for s in range(3)]
    trainer = Trainer(cfg, gen, kind, adversarial=True, disc_model=disc, ctime="adv")
    trainer.fit(lambda: iter(data), lambda: iter(data[:1]), max_iterations=4, rng_seed=7,
                plot=True)
    trainer.close()
    prefix = kind[6:]
    base = tmp_path / "checkpoints" / "conditional" / "adversarial" / "adv"
    assert (base / f"{prefix}_iteration_2.tar.pth").exists()
    assert (base / f"{prefix}_best_model.tar.pth").exists()
    assert (base / "fig" / "GeneratorTrainLoss_iteration_4.png").exists()
    path = trainer.ckpt.latest()
    assert path.endswith(f"{prefix}_iteration_4.tar.pth")
    ck = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ck) == {"epoch", "iteration", "model_state_dict", "optimizer_state_dict",
                       "loss_val_log", "disc_state_dict", "disc_optimizer_state_dict",
                       "loss_logs"}
    assert ck["iteration"] == 4 and ck["loss_val_log"] == trainer.loss_val_log
    assert {k: len(v) for k, v in ck["loss_logs"].items()} == {"t_s": 2, "t_s_o": 2, "t_d": 2,
                                                               "wd": 2}
    assert ck["loss_logs"] == trainer.loss_logs
    assert len(ck["disc_optimizer_state_dict"]["state"]) == len(list(disc.parameters()))

    fresh = cli.build_models(cfg, device="cpu")
    load_reference_checkpoint(fresh[2 + pick], path, key="disc_state_dict")
    for k, v in disc.state_dict().items():
        assert torch.equal(fresh[2 + pick].state_dict()[k], v), k

    again = Trainer(cfg, fresh[pick], kind, adversarial=True, disc_model=fresh[2 + pick],
                    ctime="adv")
    again.resume(path)
    assert (again.iteration, again.state.step, again.loss_logs) == (4, 4, trainer.loss_logs)
    for a, b in ((again.gen_model, gen), (again.disc_model, disc)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    assert _opt_equal(again.state.gen_optimizer.state_dict(),
                      trainer.state.gen_optimizer.state_dict())
    assert _opt_equal(again.state.disc_optimizer.state_dict(),
                      trainer.state.disc_optimizer.state_dict())
    again.fit(lambda: iter(data), lambda: iter(data[:1]), max_iterations=6)
    again.close()
    # iterations 4 and 5 are D steps (ratio 2)
    assert again.iteration == 6 and {k: len(v) for k, v in again.loss_logs.items()} == {
        "t_s": 2, "t_s_o": 2, "t_d": 4, "wd": 4}


def test_trainer_refuses_adversarial_without_critic(tiny_cfg, tmp_path):
    cfg = tiny_cfg.replace(src_root_dir=str(tmp_path) + "/")
    with pytest.raises(ValueError, match="disc_model"):
        Trainer(cfg, cli.build_models(cfg, device="cpu")[0], "train_text2mel", adversarial=True)


def test_plots_skip_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing the PNGs are skipped with one line each."""
    import builtins

    from spoofsv_torch.train import plot_attention, plot_losses

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    plot_attention(np.eye(4), 1, str(tmp_path / "fig"))
    plot_losses({"t_d": [1.0]}, 1, str(tmp_path / "fig"))
    assert capsys.readouterr().out.count("PNG skipped") == 2
    assert not (tmp_path / "fig").exists()


def test_critic_bridge_loads_jax_params():
    jc = JLinDisc(disc_dim=8)
    x = np.random.default_rng(2).uniform(size=(1, 40, 513)).astype(np.float32)
    params = jc.init(jax.random.PRNGKey(4), jnp.asarray(x))
    critic = load_critic_from_jax(LinDisc(8), params)
    np.testing.assert_allclose(critic(_t(x)).detach().numpy(),
                               np.asarray(jc.apply(params, jnp.asarray(x))), rtol=1e-5)
