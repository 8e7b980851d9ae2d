"""Time the WGAN-GP D step with the penalty's mixing draw made on the host
and copied to the card against drawn on the card, in one process on one GPU.

    python3 -m spoofsv_torch.train.draw_ab

On the shipping ``Config()`` at full width with seed-0 random weights and a
random batch of B=16, N=186, T=325 (f32), it runs the D step of
:func:`spoofsv_torch.train.steps.make_adversarial_steps` for Text2Mel under
"fused_pair" and SSRN under "fused_conv", in turns host, card, card, host,
host, card: 20 steps each with a synchronize after every step, then 20 back
to back. The host variant stands in for :func:`steps.draw_mixing` with
``torch.rand`` on a CPU generator and a copy, which synchronizes the stream
halfway through the step. It gates nothing.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from spoofsv_torch.cli import main as cli
from spoofsv_torch.config import Config
from spoofsv_torch.models.layers import gate_impl
from spoofsv_torch.train import steps


def host_draw(batch: int, generator, device) -> torch.Tensor:
    return torch.rand((batch, 1, 1), generator=generator).to(device)


def d_step_ms(cfg, kind, gen, disc, impl, batch, on_host: bool, n: int = 20):
    """Median ms of ``n`` synchronized D steps, then ms a step over ``n`` back to back."""
    device_draw = steps.draw_mixing
    dev = batch["mel"].device
    g = torch.Generator() if on_host else torch.Generator(device=dev)
    g.manual_seed(1)
    steps.draw_mixing = host_draw if on_host else device_draw
    try:
        with gate_impl(impl):
            init_fn, _, d_step = steps.make_adversarial_steps(gen, disc, cfg, kind)
            state, _ = d_step(init_fn(), batch, g)
            torch.cuda.synchronize()
            each = []
            for _ in range(n):
                t = time.perf_counter()
                state, _ = d_step(state, batch, g)
                torch.cuda.synchronize()
                each.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            for _ in range(n):
                state, _ = d_step(state, batch, g)
            torch.cuda.synchronize()
            return statistics.median(each), 1e3 * (time.perf_counter() - t) / n
    finally:
        steps.draw_mixing = device_draw


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda:0")
    cfg = Config()
    torch.manual_seed(0)
    melsyn, ssrn, mel_disc, lin_disc = cli.build_models(cfg, device=dev)
    rng = np.random.default_rng(0)
    B, N, T = 16, 186, 325
    arrays = {"mel": rng.uniform(0.05, 0.95, (B, T, cfg.mel.freq_bins)),
              "lin": rng.uniform(0.05, 0.95, (B, 4 * T, cfg.lin_bins)),
              "spk": rng.normal(size=(B, cfg.spk_emb_dim))}
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in arrays.items()}
    batch["text"] = torch.from_numpy(
        rng.integers(1, cfg.vocab_len - 1, (B, N)).astype(np.int32)).to(dev)
    for kind, gen, disc, impl in (("train_text2mel", melsyn, mel_disc, "fused_pair"),
                                  ("train_ssrn", ssrn, lin_disc, "fused_conv")):
        res = {"host": [], "card": []}
        for where in ("host", "card", "card", "host", "host", "card"):
            res[where].append(d_step_ms(cfg, kind, gen, disc, impl, batch, where == "host"))
        for where, r in res.items():
            print(f"[draw_ab] {kind} D step under {impl}, B={B} N={N} T={T}, draw on the "
                  f"{where}: median ms a step (synchronized each) {[round(a, 3) for a, _ in r]},"
                  f" ms a step over 20 back to back {[round(b, 3) for _, b in r]} on [{smi}]",
                  flush=True)


if __name__ == "__main__":
    main()
