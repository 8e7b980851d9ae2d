"""Rank programs: one piece of the data-parallel path on one rank each.

Each function takes the rank's :class:`~spoofsv_torch.parallel.mesh.Mesh`
first (the signature :func:`spoofsv_torch.parallel.multihost.spawn` calls),
runs one entry point over the mesh, and returns what that rank produced, on
the CPU, so a caller can hold the ranks against each other and against a
single-device run: the synthesizer (:func:`synth_rank`), the adversarial
trainer (:func:`train_rank`), the mesh-aware loader (:func:`loader_rank`)
and the HTTP server (:func:`serve_rank`).
Each also returns the hand-written kernels' launch counts of its run.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.data.pipeline import DeviceReplayLoader, TTSDataSource
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, LinDisc, MelDisc, MelSyn
from spoofsv_torch.models.layers import gate_impl
from spoofsv_torch.ops import decode_kernel, gate_kernel, gl_kernel, hconv_kernel
from spoofsv_torch.parallel.mesh import Mesh, all_reduce_grads, batch_sharding, replicate_tree
from spoofsv_torch.serve import (BatchingSynthesizer, SpeakerTable, make_http_server,
                                 serve_follower)
from spoofsv_torch.train import Trainer, steps

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kernel_counters() -> Dict[str, object]:
    """The launch counters of every hand-written kernel's wrapper, by the
    kernels' names in ``chip_smoke.py``'s line."""
    return {"decode": decode_kernel.decode_kernel, "decode_f32": decode_kernel.f32_kernel,
            "gl_init": gl_kernel.init_kernel, "griffin_lim": gl_kernel.gl_tc_kernel,
            "griffin_lim_f32": gl_kernel.gl_kernel, "highway_gate": gate_kernel.gate_kernel,
            "highway_conv": hconv_kernel.hconv_kernel,
            "highway_conv_pair": hconv_kernel.hconv_pair_kernel}


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """Every kernel's launches inside the block (counts reset on entry)."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        out.update({k: c.launches for k, c in counters.items()})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _aligned(mesh: Mesh) -> None:
    """Return once every rank has reached this point (and its device work is
    done), so that a collective timed next excludes the ranks' skew."""
    _sync(mesh.device)
    mesh.all_reduce_(torch.zeros(1, device=mesh.device))
    _sync(mesh.device)


def build_generators(cfg: Config, state_dicts: Dict[str, dict], device, dtype: torch.dtype):
    """Text2Mel and SSRN at ``cfg``'s widths from ``state_dicts`` ("text2mel", "ssrn")."""
    melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                    cfg.hidden_dim)
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
    melsyn.load_state_dict(state_dicts["text2mel"])
    ssrn.load_state_dict(state_dicts["ssrn"])
    return melsyn.to(device, dtype).eval(), ssrn.to(device, dtype).eval()


def modules_rank(mesh: Mesh) -> List[str]:
    """The modules this rank has loaded: a spawned rank loads only what its
    program imports."""
    return sorted(sys.modules)


def collectives_rank(mesh: Mesh) -> Dict[str, tuple]:
    """The mesh's collectives on known values: each entry is (what this rank
    got, what it should get), equal bit for bit when the mesh works. An
    all-gather of bf16 rows, a broadcast of a module's parameters, the
    bucketed gradient mean (buckets of 16 bytes), an object broadcast and a
    mean."""
    r, n, dev = mesh.rank, mesh.size, mesh.device
    rows = torch.arange(6, dtype=torch.bfloat16, device=dev).reshape(3, 2)
    lin = torch.nn.Linear(3, 2).to(dev)
    torch.nn.init.constant_(lin.weight, float(r))
    replicate_tree(lin, mesh)
    for p in lin.parameters():
        p.grad = torch.full_like(p, float(r + 1))
    all_reduce_grads(lin.parameters(), mesh, bucket_bytes=16)
    cpu = lambda t: t.detach().cpu()   # noqa: E731
    return {"gather": (cpu(mesh.all_gather(rows + 10 * r)),
                       torch.cat([cpu(rows) + 10 * k for k in range(n)])),
            "weight": (cpu(lin.weight), torch.zeros(2, 3)),
            "grad": (cpu(lin.weight.grad), torch.full((2, 3), (n + 1) / 2)),
            "object": (torch.tensor(mesh.broadcast_object({"from": r})["from"]),
                       torch.tensor(0)),
            "mean": (cpu(mesh.mean(torch.tensor([float(r)], device=dev))),
                     torch.tensor([(n - 1) / 2]))}


def synth_rank(mesh: Mesh, cfg: Config, state_dicts: Dict[str, dict], text: np.ndarray,
               spk: np.ndarray, seeds: Optional[np.ndarray] = None,
               n_frames: Optional[int] = None, gl_iters: Optional[int] = None,
               dtype: str = "float32", impl: str = "xla", reps: int = 1,
               cudnn: bool = True) -> dict:
    """One :class:`~spoofsv_torch.infer.synthesize.Synthesizer` call over
    the mesh on the global batch (every rank passes the same one), with
    cuDNN on or off (``cudnn``). Returns
    the gathered ``audio``, ``mel``, ``attn``; this rank's rows as it
    computed them (``local``, from :meth:`Synthesizer.call_local`); the
    kernels' ``launches`` in the call; and, over ``reps`` more calls, the
    host-clock ms of this rank's local call and of the audio's all-gather
    (timed from a point where both ranks have arrived)."""
    melsyn, ssrn = build_generators(cfg, state_dicts, mesh.device, DTYPES[dtype])
    seeds_t = None if seeds is None else torch.from_numpy(np.asarray(seeds, np.int32))
    with gate_impl(impl), torch.backends.cudnn.flags(enabled=cudnn):
        syn = Synthesizer(cfg, melsyn, ssrn, n_frames=n_frames, gl_iters=gl_iters, mesh=mesh)
        _sync(mesh.device)
        with counting() as launches:
            audio, mel, attn = syn(text, spk, seeds_t)
            _sync(mesh.device)
        sl = batch_sharding(mesh, len(text))
        local_args = (text[sl], spk[sl], None if seeds_t is None else seeds_t[sl])
        local = syn.call_local(*local_args)
        local_ms, gather_ms = [], []
        for _ in range(reps):
            _sync(mesh.device)
            t0 = time.perf_counter()
            a, _, _ = syn.call_local(*local_args)
            _sync(mesh.device)
            t1 = time.perf_counter()
            _aligned(mesh)
            t2 = time.perf_counter()
            mesh.all_gather(a)
            _sync(mesh.device)
            local_ms.append(1e3 * (t1 - t0))
            gather_ms.append(1e3 * (time.perf_counter() - t2))
    cpu = lambda t: t.float().cpu()   # noqa: E731
    return {"audio": cpu(audio), "mel": cpu(mel), "attn": cpu(attn),
            "local": tuple(cpu(t) for t in local), "rows": (sl.start, sl.stop),
            "launches": launches, "local_ms": local_ms, "gather_ms": gather_ms}


def train_rank(mesh: Mesh, cfg: Config, kind: str, gen_state: dict, disc_state: dict,
               batches: Sequence[Dict[str, np.ndarray]], iterations: int,
               use_masks: bool = False, gan_type: str = "wgan-gp", impl: str = "xla",
               draws: Optional[List[np.ndarray]] = None, rng_seed: int = 0,
               workdir: Optional[str] = None,
               val_batches: Optional[Sequence[Dict[str, np.ndarray]]] = None,
               start_step: int = 0) -> dict:
    """``Trainer.fit`` (adversarial, ``kind`` "train_text2mel" or
    "train_ssrn") over the mesh on ``batches``, the global batches of one
    epoch, for ``iterations`` iterations, from ``gen_state``/``disc_state``
    at ``cfg``'s widths. ``draws``: the penalty's mixing draws for the
    global batch, one (B, 1, 1) array a D step in order, in place of the
    trainer's own (to hold the run to another implementation's draws).
    ``val_batches``: validate (the autoregressive decode for Text2Mel) on
    them after the last iteration. ``start_step``: the adversarial step
    count to start from (1: a D step first, so the critic's first step
    runs from the weights it was given). Returns the final state dicts and Adam
    moments on the CPU, the gradients each net's optimizer stepped on first
    (``first_grads``: the first G and D steps', all-reduced), the loss logs,
    the kernels' launches, each iteration's host-clock ms and the ms of one
    all-reduce of the generator's gradients (timed from a point where every
    rank has arrived)."""
    if kind == "train_text2mel":
        gen = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                     cfg.hidden_dim)
        disc = MelDisc(cfg.disc_dim, freq_bins=cfg.mel.freq_bins)
    else:
        gen = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
        disc = LinDisc(cfg.disc_dim, lin_bins=cfg.lin_bins)
    gen.load_state_dict(gen_state)
    gen = gen.to(mesh.device)
    disc.load_state_dict(disc_state)
    disc = disc.to(mesh.device)
    cfg = cfg.replace(src_root_dir=(workdir or tempfile.mkdtemp(prefix="spoofsv_rank_")) + "/",
                      val_every_iter=iterations if val_batches else 10 ** 9)
    with gate_impl(impl), _handed_draws(steps, draws):
        trainer = Trainer(cfg, gen, kind, adversarial=True, gan_type=gan_type, disc_model=disc,
                          ctime=f"rank{mesh.rank}", use_masks=use_masks,
                          validate_with_decode=val_batches is not None, mesh=mesh)
        trainer.init()
        trainer.state.step = start_step
        first_grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for net, module, opt in (("gen", gen, trainer.state.gen_optimizer),
                                 ("disc", disc, trainer.state.disc_optimizer)):
            opt.step = _recording_step(opt.step, net, module, first_grads)
        step_ms: List[float] = []
        run = trainer.train_iteration

        def timed(batch):
            _sync(mesh.device)
            t0 = time.perf_counter()
            m = run(batch)
            _sync(mesh.device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return m

        trainer.train_iteration = timed
        with counting() as launches:
            trainer.fit(lambda: iter(batches),
                        None if val_batches is None else lambda: iter(val_batches),
                        max_epochs=10 ** 9, max_iterations=iterations, rng_seed=rng_seed)
        trainer.close()
    for p in gen.parameters():
        p.grad = torch.zeros_like(p)
    _aligned(mesh)
    t0 = time.perf_counter()
    all_reduce_grads(gen.parameters(), mesh)
    _sync(mesh.device)
    allreduce_ms = 1e3 * (time.perf_counter() - t0)
    state = trainer.state
    moments = {f"{net}.{i}.{k}": v.detach().cpu()
               for net, opt in (("gen", state.gen_optimizer), ("disc", state.disc_optimizer))
               for i, p in enumerate(q for g in opt.param_groups for q in g["params"])
               for k, v in opt.state.get(p, {}).items() if k in ("exp_avg", "exp_avg_sq")}
    trainer._flush_loss_logs()
    return {"gen": {k: v.detach().cpu() for k, v in gen.state_dict().items()},
            "disc": {k: v.detach().cpu() for k, v in disc.state_dict().items()},
            "moments": moments, "first_grads": first_grads, "loss_logs": trainer.loss_logs,
            "launches": launches, "val": trainer.loss_val_log,
            "step_ms": step_ms, "allreduce_ms": allreduce_ms, "iteration": trainer.iteration}


def _recording_step(step, net: str, module: torch.nn.Module, store: dict):
    """``optimizer.step`` that first records the gradients of its first call."""
    def run(*a, **kw):
        if net not in store:
            store[net] = {k: p.grad.detach().cpu().clone()
                          for k, p in module.named_parameters() if p.grad is not None}
        return step(*a, **kw)
    return run


@contextlib.contextmanager
def _handed_draws(steps, draws: Optional[List[np.ndarray]]) -> Iterator[None]:
    """``steps.draw_mixing`` returning ``draws`` in order inside the block."""
    orig = steps.draw_mixing
    if draws is not None:
        it = iter(draws)
        steps.draw_mixing = lambda b, g, d: torch.from_numpy(np.asarray(next(it))).to(d)
    try:
        yield
    finally:
        steps.draw_mixing = orig


def loader_rank(mesh: Mesh, cfg: Config, batch_size: int, seed: int, epochs: int,
                with_lin: bool = False, drop_last: bool = False) -> List[dict]:
    """The batches of ``epochs`` epochs of a ``DeviceReplayLoader`` over
    the mesh (this rank's rows), as numpy."""
    loader = DeviceReplayLoader(TTSDataSource(cfg, "train"), batch_size, with_lin=with_lin,
                                seed=seed, drop_last=drop_last, mesh=mesh)
    return [{k: v.cpu().numpy() for k, v in b.items()} for _ in range(epochs) for b in loader]


def serve_rank(mesh: Mesh, cfg: Config, state_dicts: Dict[str, dict],
               requests: Sequence[dict], max_batch: int = 4, dtype: str = "float32",
               concurrent: bool = False) -> dict:
    """Data-parallel serving: rank 0 runs a ``BatchingSynthesizer`` (no
    trim) behind ``make_http_server`` on a free localhost port and POSTs
    ``requests`` (JSON bodies) to ``/synthesize``, one after another or, with
    ``concurrent``, all at once; the other ranks run ``serve_follower``.
    Rank 0 returns the ladder, each reply's status and body (JSON replies
    decoded, wav bytes as they came) and the kernels' launches; the others
    the number of calls they followed."""
    melsyn, ssrn = build_generators(cfg, state_dicts, mesh.device, DTYPES[dtype])
    syn = Synthesizer(cfg, melsyn, ssrn, mesh=mesh)
    if mesh.rank > 0:
        return {"calls": serve_follower(cfg, syn)}
    batcher = BatchingSynthesizer(cfg, syn, max_batch=max_batch, batch_wait_ms=50.0,
                                  trim_db=None)
    httpd = make_http_server(batcher, SpeakerTable(cfg.spk_emb_dir), port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/synthesize"
    replies: List[Optional[tuple]] = [None] * len(requests)

    def post(i: int) -> None:
        req = urllib.request.Request(url, data=json.dumps(requests[i]).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                body = r.read()
                replies[i] = (r.status, json.loads(body) if r.headers.get_content_type()
                              == "application/json" else body)
        except urllib.error.HTTPError as e:
            replies[i] = (e.code, e.read())

    try:
        with counting() as launches:
            if concurrent:
                threads = [threading.Thread(target=post, args=(i,)) for i in range(len(requests))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
            else:
                for i in range(len(requests)):
                    post(i)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    return {"ladder": batcher._ladder(), "replies": replies, "launches": launches,
            "stats": batcher.stats_dict()}
