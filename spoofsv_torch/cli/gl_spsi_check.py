"""``python -m spoofsv_torch.cli.gl_spsi_check [--root DIR] [campaign flags]``: SPSI GL by attack.

Port of ``scripts/gl_spsi_check.py``: do the EERs, spoof rates and CM EER
hold when every spoof wav is vocoded with the SPSI init at 16 and at 12
iterations? For each candidate of :data:`CANDIDATES` it writes
``<root>/config_gl{init}{iters}.json`` (the campaign's ``config.json`` with
those two ``TPU`` fields), regenerates the spoof set ``campaign_gl{init}{iters}``
from the same trained ordinary TTS (unless its wavs exist), and re-scores it
with the same trained GE2E embedder, the cached i-vector models and the
same CM, through :class:`~spoofsv_torch.cli.campaign.Campaign`'s own stages.
The result, with the base campaign's numbers as ``base_production``, goes
to ``<root>/state/gl_spsi_check.json``.

The JAX script hands ``campaign.py`` only the root, so it scores at the
campaign's default depth, whatever depth the tree was made at. This port
takes every flag of ``campaign.build_parser()`` (the root defaulting to
``$SPOOFSV_CAMPAIGN_ROOT`` when that is set, as there): with no depth flag it
behaves as the JAX script; a reduced-depth tree is scored with the depth it
was made at. Needs the base campaign's ``synthesize``, ``ge2e``, ``ivector``
and ``cm`` stages. Runs on the card unless :func:`main` is given
``device="cpu"``: K1 bf16, K2 and K3 for the spoof set.
"""

from __future__ import annotations

import json
import os

from spoofsv_torch.cli import checklib

CANDIDATES = [(16, "spsi"), (12, "spsi")]


def score_candidate(c, iters: int, init: str) -> dict:
    """One candidate on the campaign ``c``: its config, spoof set and scores."""
    tag = f"campaign_gl{init}{iters}"
    out = {"griffin_lim_iters": iters, "griffin_lim_init": init}
    cfg_path = checklib.config_variant(c, f"config_gl{init}{iters}.json",
                                       {"griffin_lim_iters": iters, "griffin_lim_init": init})
    return checklib.rescore(c, tag, cfg_path, f"_gl{init}{iters}", out)


def main(argv=None, device=None) -> dict:
    """Score every candidate on ``device`` (the card unless ``device="cpu"``);
    returns what it writes to ``state/gl_spsi_check.json``."""
    c = checklib.campaign_check(argv, device, root_env=True)
    out = {"candidates": [score_candidate(c, i, m) for i, m in CANDIDATES]}
    out["base_production"] = checklib.base_summary(c)
    with open(os.path.join(c.state, "gl_spsi_check.json"), "w") as f:
        json.dump(out, f, indent=2, default=float)
    print(json.dumps({"base_production": out["base_production"],
                      "candidates": [{k: v for k, v in cand.items() if k != "spoofgen"}
                                     for cand in out["candidates"]]},
                     indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
