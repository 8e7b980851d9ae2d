"""spoofsv_torch imports no jax (nor flax, optax, yaml or spoofsv_tpu), and its
kernel wrappers never fall back.

A CUDA request with no card raises; a non-CPU tensor reaches the kernel path
(where it launches or raises), never the plain version.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import spoofsv_torch

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(spoofsv_torch.__path__, "spoofsv_torch."))


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.decode_kernel", "ops.gl_kernel", "ops.gate_kernel", "ops.hconv_kernel",
              "train.losses", "train.state", "train.steps", "train.loop", "cli.main",
              "config", "export", "weights", "serve", "spoofkit.spoofgen", "cli.serve",
              "cli.generate_test_utterances", "data.pipeline", "data.toy", "data.vctk",
              "models.discriminator", "spoofkit.mcd", "native", "spoofkit.flacio",
              "spoofkit.vad", "spoofkit.ge2e_harness", "spoofkit.dvector", "models.ge2e",
              "cli.ge2e", "cli.metagen", "spoofkit.ivector", "spoofkit.ivector_torch",
              "spoofkit.antispoof", "spoofkit.curve", "cli.ivector", "cli.antispoof",
              "cli.curve"):
        assert f"spoofsv_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.startswith(('jax', 'flax', 'optax', 'yaml')))\n"
            "assert not bad, bad\n"
            "from spoofsv_torch.models.discriminator import DRS, ResBasicBlock\n"
            "import spoofsv_torch.native as native\n"
            "assert native._LIB is None, 'importing built libspoofkit'\n"
            "ref = sorted(m for m in sys.modules if m.startswith('spoofsv_tpu'))\n"
            "assert not ref, ref\n"
            "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py imports neither jax/flax/optax/yaml nor spoofsv_tpu, at any depth."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    assert "spoofsv_torch.ops" in names
    bad = [n for n in names if n.split(".")[0] in ("spoofsv_tpu", "jax", "flax", "optax", "yaml")]
    assert not bad, bad


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        spoofsv_torch.resolve_device("cuda")
    # the default is the card: without one it raises, and the CPU is reached
    # only when asked for
    with pytest.raises(RuntimeError):
        spoofsv_torch.resolve_device(None)
    assert spoofsv_torch.resolve_device("cpu") == torch.device("cpu")
    # the countermeasure's CLI asks for the card before it reads anything
    from spoofsv_torch.cli import antispoof

    with pytest.raises(RuntimeError):
        antispoof.main(["train", "-C", "no-such-config.json", "-T", "t"])


def test_wrappers_take_the_kernel_path_for_non_cpu_tensors():
    """Meta tensors are not CPU tensors: each wrapper goes to its kernel path
    and raises there (no card, or not a CUDA tensor) instead of falling back."""
    from spoofsv_torch.ops import decode_kernel, gl_kernel

    mag = torch.empty(1, 8, 513, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        gl_kernel.gl_init_angles(mag, 1024, 256, "advance")
    with pytest.raises((RuntimeError, ValueError)):
        gl_kernel.griffin_lim_fused(mag, 1024, 256, n_iter=1,
                                    init_angles=(torch.empty_like(mag), torch.empty_like(mag)))
    K = torch.empty(2, 5, 32, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        decode_kernel.decode_fused({}, K, K, None, None, n_frames=3, freq_bins=16)

    from spoofsv_torch.ops import gate_kernel, hconv_kernel

    x = torch.empty(2, 9, 32, device="meta")
    w, v, v2 = (torch.empty(*s, device="meta") for s in ((64, 32, 3), (32,), (64,)))
    with pytest.raises((RuntimeError, ValueError)):
        gate_kernel.fused_highway_gate(torch.empty(2, 9, 64, device="meta"), x, v, v, v, v)
    with pytest.raises((RuntimeError, ValueError)):
        hconv_kernel.fused_highway_conv(x, w, v2, v, v, v, v, 1, False)
    with pytest.raises((RuntimeError, ValueError)):
        hconv_kernel.fused_highway_conv_pair(x, w, v2, v, v, v, v, w, v2, v, v, v, v, 1, 3, False)
    assert (gate_kernel.gate_kernel.launches, hconv_kernel.hconv_kernel.launches,
            hconv_kernel.hconv_pair_kernel.launches) == (0, 0, 0)
