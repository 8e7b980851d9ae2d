"""Where a training step's time goes, f32 against bf16 autocast, on the card.

Run alone on one GPU:

    python3 -m spoofsv_torch.train.step_profile

Text2Mel at full width (random weights from seed 0) on one synthetic batch
of the training phase's shape (B=16, N=186, T=325), under "xla" and
"fused_pair": the ordinary step, and the WGAN-GP G and D steps with the mel
critic. For each, f32 and bf16: the host-clock median of 5 steps after 3
warm-up steps (``torch.cuda.synchronize()`` around each), then one step
under ``torch.profiler``: its device-busy ms (every kernel and copy), the
kernel count, the aten calls (nested ones too), the device ms by kernel
family, and the aten ops with the most device time of their own. It prints one JSON object per step and
gates nothing.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from spoofsv_torch.cli.main import build_models
from spoofsv_torch.config import Config
from spoofsv_torch.models.layers import gate_impl
from spoofsv_torch.ops import _build
from spoofsv_torch.train import steps

SHAPE = dict(B=16, N=186, T=325)
# kernel families, by a piece of the kernel's name (first match wins)
FAMILIES = (("highway kernels", ("hconv_kernel", "gate_kernel")),
            ("casts and copies", ("copy", "Memcpy", "Memset")),
            ("layer norm", ("layer_norm", "LayerNorm")),
            ("gemm and conv", ("gemm", "conv", "xmma", "cutlass", "cudnn", "sm90")),
            ("reductions", ("reduce",)))


def _profile(step) -> Dict[str, object]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    family = dict.fromkeys([f for f, _ in FAMILIES] + ["other"], 0.0)
    for e in kernels:
        name = next((f for f, keys in FAMILIES if any(k in e.name for k in keys)), "other")
        family[name] += e.time_range.elapsed_us() / 1e3
    ops, aten_calls = [], 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("aten::"):
            aten_calls += e.count
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            if us:
                ops.append((round(us / 1e3, 3), e.count, e.key))
    ops.sort(reverse=True)
    return {"device_busy_ms": round(sum(family.values()), 3), "kernels": len(kernels),
            "aten_calls": aten_calls,
            "by_family_ms": {k: round(v, 3) for k, v in family.items()},
            "top_ops": [{"op": k, "calls": n, "self_device_ms": ms} for ms, n, k in ops[:10]]}


def main() -> None:
    dev = torch.device("cuda")
    _build.build_all()
    cfg = Config()
    B, N, T = SHAPE["B"], SHAPE["N"], SHAPE["T"]
    rng = np.random.default_rng(2)
    batch = {"text": torch.from_numpy(rng.integers(1, cfg.vocab_len - 1, (B, N))),
             "mel": torch.from_numpy(rng.uniform(0.05, 0.95, (B, T, cfg.mel.freq_bins))
                                     .astype(np.float32)),
             "spk": torch.from_numpy(rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.manual_seed(0)
    melsyn, _, critic, _ = build_models(cfg, device=dev)
    init = ({k: v.clone() for k, v in melsyn.state_dict().items()},
            {k: v.clone() for k, v in critic.state_dict().items()})
    mixing = torch.Generator(device=dev).manual_seed(0)
    for impl in ("xla", "fused_pair"):
        for dt in (torch.float32, torch.bfloat16):
            melsyn.load_state_dict(init[0])
            critic.load_state_dict(init[1])
            with gate_impl(impl):
                o_init, o_step = steps.make_ordinary_step(melsyn, cfg, "train_text2mel",
                                                          compute_dtype=dt)
                a_init, g_step, d_step = steps.make_adversarial_steps(
                    melsyn, critic, cfg, "train_text2mel", compute_dtype=dt)
                o_state, a_state = o_init(), a_init()
                for name, step in (("ordinary", lambda: o_step(o_state, batch)),
                                   ("G", lambda: g_step(a_state, batch)),
                                   ("D", lambda: d_step(a_state, batch, mixing))):
                    ms = []
                    for i in range(8):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        step()
                        torch.cuda.synchronize()
                        if i >= 3:
                            ms.append(1e3 * (time.perf_counter() - t))
                    row = {"impl": impl, "dtype": str(dt)[6:], "step": name, "shape": SHAPE,
                           "host_ms_median": round(statistics.median(ms), 3),
                           "host_ms": [round(v, 3) for v in ms], **_profile(step)}
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
