"""Pytest set-up for the benchmark's CPU tests: the Tacotron 2 cell's tiny sizes.

``tests/conftest.py`` sizes the DCTTS configurations and knows the tiny
mixes of the kinds ``bulk``, ``serve`` and ``train``. Before any test of
``portbench/`` runs, this file's session fixture adds the cell
``tacotron2-sv2tts.bulk160-ar1000``'s tiny widths (``T2_TINY``) and its
kind's tiny mix (``T2_MIX``) to every loaded copy of that module, so that the
tests that run every cell find them whichever test files were collected."""

import sys
from pathlib import Path

import pytest

CONFIG = "tacotron2-sv2tts"
# n_mel_channels stays at the published 80: the pseudo-inverse of a basis of a
# few bins clamps most of the magnitude to zero, where SPSI picks its peaks
# otherwise on rounding and the two Griffin-Lims' spectral convergences part
T2_TINY = {"symbols_embedding_dim": 16, "encoder_embedding_dim": 16, "speaker_embedding_dim": 8,
           "n_mel_channels": 80, "attention_rnn_dim": 32, "decoder_rnn_dim": 24,
           "prenet_dim": 16, "attention_dim": 8, "attention_location_n_filters": 4,
           "attention_location_kernel_size": 7, "postnet_embedding_dim": 16}
T2_MIX = {"speakers_per_call": 2, "sentences": 3, "warmup_calls": 1, "frames": 24}
TABLES = Path(__file__).resolve().parent / "tests" / "conftest.py"


def extend(module) -> None:
    """Add the cell's tiny sizes to one loaded copy of ``tests/conftest.py``."""
    if "bulk_tacotron2" in module.TINY_MIX:
        return
    module.TINY_MIX["bulk_tacotron2"] = T2_MIX
    dctts_config = module.Tiny.config

    def config(self, name):
        if name != CONFIG:
            return dctts_config(self, name)
        c = self.real_config(name)
        c["config"].update(T2_TINY)
        c["config"]["TPU"]["griffin_lim_iters"] = 3
        return c

    module.Tiny.config = config


@pytest.fixture(scope="session", autouse=True)
def tacotron2_tiny_sizes():
    """pytest loads ``tests/conftest.py`` under its own module name, the
    tests import it as ``portbench.tests.conftest``: extend every copy."""
    import portbench.tests.conftest  # noqa: F401

    for module in list(sys.modules.values()):
        path = getattr(module, "__file__", None)
        if path and Path(path).resolve() == TABLES:
            extend(module)
