"""``python -m spoofsv_torch.cli.serve``: the micro-batching synthesis server.

Port of :mod:`spoofsv_tpu.cli.serve`: serves trained checkpoints
(``config.json`` ``INFERENCE_TEXT2MEL_MODEL`` / ``INFERENCE_SSRN_MODEL``,
reference ``.tar.pth``) behind an HTTP endpoint with micro-batching on one
card (:mod:`spoofsv_torch.serve`), or data-parallel over the ``--mesh``
ranks: rank 0 serves HTTP and batches, the other ranks follow its calls
(:func:`spoofsv_torch.serve.serve_follower`). ``--trace_dir DIR`` writes a
``torch.profiler`` trace of the whole run (every thread's spans) when
the server stops.
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None) -> None:
    """Load the models, warm every bucket and serve until interrupted, on
    the card unless ``device`` says otherwise."""
    ps = argparse.ArgumentParser(description="spoofsv synthesis server")
    ps.add_argument("-C", "--configuration", type=str, default=None)
    ps.add_argument("--host", type=str, default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8571)
    ps.add_argument("--max_batch", type=int, default=8,
                    help="micro-batch aggregation limit (power-of-two batch ladder below it)")
    ps.add_argument("--batch_wait_ms", type=float, default=10.0,
                    help="max time to wait for co-batched requests after the first arrives")
    ps.add_argument("--trim_db", type=float, default=30.0,
                    help="output silence trim threshold (reference "
                         "generate_test_utterances.py:136); negative disables")
    ps.add_argument("--max_seconds", type=float, default=None,
                    help="cap output duration (reference caps spoof utts at 9 s)")
    ps.add_argument("--no_warmup", action="store_true",
                    help="skip running every ladder rung and frames bucket once at start-up")
    ps.add_argument("--frames_buckets", type=str, default=None,
                    help="comma-separated rollout-length ladder (e.g. '120,200,325'): short "
                         "texts decode a shorter rollout. Default: one full-length bucket "
                         "(reference behavior, MAX_FRAME_NUM)")
    ps.add_argument("--frames_per_char", type=float, default=3.0,
                    help="frames-bucket estimator: bucket holding frames_per_char*len(text)")
    ps.add_argument("--speculative", action="store_true",
                    help="retry sub-maximal-bucket requests whose decode didn't consume the "
                         "text (monotonic-attention completion check) one bucket up instead "
                         "of truncating")
    ps.add_argument("--attn_trim", type=int, default=None, metavar="PAD",
                    help="attention-gated END trim: cut each waveform PAD decoder frames "
                         "after its decode consumed the text; off by default")
    ps.add_argument("--max_queue", type=int, default=None,
                    help="admission bound: pending requests beyond this get 503 + "
                         "Retry-After (default 16*max_batch; 0 = unbounded)")
    ps.add_argument("--request_timeout", type=float, default=600.0,
                    help="per-request wait (s); timed-out requests are skipped by the "
                         "batcher if still queued")
    from spoofsv_torch.cli.main import add_mesh_args, add_trace_arg

    add_mesh_args(ps, "data-parallel serving")
    add_trace_arg(ps)
    args = ps.parse_args(argv)

    from spoofsv_torch import resolve_device
    from spoofsv_torch.cli.main import (apply_runtime_knobs, build_models, data_parallel,
                                        inference_dtype)
    from spoofsv_torch.config import load_config
    from spoofsv_torch.infer.synthesize import Synthesizer
    from spoofsv_torch.serve import serve_follower
    from spoofsv_torch.utils import profiling
    from spoofsv_torch.weights import load_generator_params

    dev = resolve_device(device)
    cfg = load_config(args.configuration)
    apply_runtime_knobs(cfg, infer=True)
    with data_parallel(args, cfg, dev, "spoofsv_torch.cli.serve", argv) as mesh, \
            profiling.trace(args.trace_dir):
        dev = dev if mesh is None else mesh.device
        melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, dev),
                                          device=dev)
        load_generator_params(cfg.inference_text2mel_model, melsyn)
        load_generator_params(cfg.inference_ssrn_model, ssrn)
        syn = Synthesizer(cfg, melsyn, ssrn, mesh=mesh)
        if mesh is not None and mesh.rank > 0:
            print(f"[serve] rank {mesh.rank}: ran {serve_follower(cfg, syn)} calls", flush=True)
            return
        _serve(args, cfg, syn, dev)


def _serve(args, cfg, syn, dev) -> None:
    """Rank 0 (or the only process): warm up, then serve HTTP until interrupted."""
    import torch

    from spoofsv_torch.serve import BatchingSynthesizer, SpeakerTable, make_http_server

    batcher = BatchingSynthesizer(
        cfg, syn, max_batch=args.max_batch, batch_wait_ms=args.batch_wait_ms,
        trim_db=args.trim_db if args.trim_db >= 0 else None,
        max_seconds=args.max_seconds,
        frames_buckets=[int(x) for x in args.frames_buckets.split(",")]
        if args.frames_buckets else None,
        frames_per_char=args.frames_per_char,
        max_queue=args.max_queue, speculative=args.speculative,
        attn_trim=args.attn_trim)
    try:
        if not args.no_warmup:
            print(f"[serve] warming the batch ladder {batcher._ladder()} x frames buckets "
                  f"{batcher.frames_buckets} ...", flush=True)
            batcher.warmup()
        speakers = SpeakerTable(cfg.spk_emb_dir)
        httpd = make_http_server(batcher, speakers, host=args.host, port=args.port,
                                 request_timeout=args.request_timeout)
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        ranks = "" if syn.mesh is None else f", {syn.mesh.size} ranks"
        print(f"[serve] listening on http://{args.host}:{httpd.server_address[1]} "
              f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms, device={dev} "
              f"{where}{ranks})", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
    finally:
        batcher.close()

if __name__ == "__main__":
    main()
