"""``python -m spoofsv_torch.cli.gl24_check [--root DIR] [campaign flags]``: GL24 by attack.

Port of ``scripts/gl24_check.py``: do the verification metrics hold when
every spoof wav goes through 24 Griffin-Lim iterations (the configuration's
init kept)? It writes ``<root>/config_gl24.json`` (``config.json`` with
``TPU.griffin_lim_iters`` 24), regenerates the spoof set ``campaign_gl24``
from the same trained ordinary TTS (unless its wavs exist) and re-scores it
with the same trained GE2E embedder, the cached i-vector models and the same
CM, through :class:`~spoofsv_torch.cli.campaign.Campaign`'s own stages. The
result, with the base campaign's numbers under the JAX script's key
``base_gl32``, goes to ``<root>/state/gl24_check.json``.

The JAX script hands ``campaign.py`` no flag at all, so it scores the
default root at the campaign's default depth. This port takes every flag of
``campaign.build_parser()``: with none it behaves as the JAX script; a
reduced-depth tree is scored with the depth it was made at. Needs the base
campaign's ``synthesize``, ``ge2e``, ``ivector`` and ``cm`` stages. Runs on
the card unless :func:`main` is given ``device="cpu"``.
"""

from __future__ import annotations

import json
import os

from spoofsv_torch.cli import checklib

TAG24 = "campaign_gl24"


def main(argv=None, device=None) -> dict:
    """Score the GL24 spoof set on ``device`` (the card unless
    ``device="cpu"``); returns what it writes to ``state/gl24_check.json``."""
    c = checklib.campaign_check(argv, device)
    cfg24 = checklib.config_variant(c, "config_gl24.json", {"griffin_lim_iters": 24})
    out = checklib.rescore(c, TAG24, cfg24, "_gl24", {})
    out["base_gl32"] = checklib.base_summary(c)
    with open(os.path.join(c.state, "gl24_check.json"), "w") as f:
        json.dump(out, f, indent=2, default=float)
    print(json.dumps({k: v for k, v in out.items() if k != "spoofgen"}, indent=2,
                     default=float))
    return out


if __name__ == "__main__":
    main()
