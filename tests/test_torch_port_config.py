"""The port's own configuration and parameter export vs the JAX package's.

``spoofsv_torch.config`` and ``spoofsv_torch.export`` are copies that keep the
port free of ``spoofsv_tpu``; here they are held to the originals: the same
``Config()`` field by field, the same ``load_config`` result on one JSON, and
the same state-dict keys, shapes and values from parameters initialised from
one seed.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spoofsv_tpu import config as jconfig
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.train.steps import shift_right
from spoofsv_tpu.utils import torch_export as jexport
from spoofsv_torch import config, export


def test_default_config_equals_jax():
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(jconfig.Config())
    for name in ("STFTConfig", "MelConfig", "NormConfig", "AdamConfig", "TPUConfig"):
        ours, ref = getattr(config, name), getattr(jconfig, name)
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(ref)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), name
    cfg = config.Config()
    assert (cfg.vocab_len, cfg.lin_bins) == (jconfig.Config().vocab_len, jconfig.Config().lin_bins)


@pytest.mark.parametrize("doc", [
    {},
    {"HIDDEN_DIM": 64, "STFT": {"FFT_LENGTH": 512, "HOP_LENGTH": 128},
     "COARSE_MELSPEC": {"FREQ_BINS": 40}, "NORM_POWER": {"ANALYSIS": 0.5},
     "ADAM": {"ALPHA": 1e-3}, "LOG_FEATURE": True, "RATIO": 3,
     "TPU": {"griffin_lim_iters": 64, "griffin_lim_init": "random",
             "bucket_frames": [80, 325], "highway_gate_impl": "fused_pair"}},
])
def test_load_config_equals_jax(tmp_path, doc):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(doc))
    ours = config.load_config(str(path), batch_size=4)
    ref = jconfig.load_config(str(path), batch_size=4)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_reference_dict() == ref.to_reference_dict()


def _assert_same_state(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("condition", [True, False])
def test_export_melsyn_equals_jax(condition):
    rng = np.random.default_rng(0)
    m = JMelSyn(vocab_len=34, condition=condition, spk_emb_dim=10, text_emb_dim=8,
                freq_bins=16, hidden_dim=16)
    text = jnp.asarray(rng.integers(1, 30, (2, 7)), jnp.int32)
    spk = jnp.asarray(rng.normal(size=(2, 10)), jnp.float32)
    mel = jnp.asarray(rng.uniform(0.1, 0.9, (2, 5, 16)), jnp.float32)
    params = m.init(jax.random.PRNGKey(0), shift_right(mel), text, spk)
    ref = jexport.export_melsyn(params)
    _assert_same_state(export.export_melsyn(params), ref)
    # the same from nested dicts of numpy arrays, without the "params" level
    _assert_same_state(export.export_melsyn(jax.tree.map(np.asarray, dict(params["params"]))),
                       ref)


def test_export_ssrn_equals_jax():
    rng = np.random.default_rng(1)
    s = JSSRN(freq_bins=16, output_bins=33, ssrn_dim=16)
    params = s.init(jax.random.PRNGKey(1),
                    jnp.asarray(rng.uniform(0.1, 0.9, (2, 4, 16)), jnp.float32))
    ref = jexport.export_ssrn(params)
    _assert_same_state(export.export_ssrn(params), ref)
    _assert_same_state(export.export_ssrn(jax.tree.map(np.asarray, dict(params))), ref)
