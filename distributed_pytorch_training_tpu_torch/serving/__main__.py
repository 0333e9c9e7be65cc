"""``python -m distributed_pytorch_training_tpu_torch.serving smoke`` — the
batched inference engine on the GPU.

Commands:
  smoke [--ckpt-dir D [--zero1 | --fsdp-explicit]]
        [--prompt 12,7,99 | --prompt-len N] [--serve-dtype fp32|bf16|int8]
      Build the engine (restoring the newest manifest-verified checkpoint
      under --ckpt-dir, written under the given update mode, and logging
      its label and tree digest; random-init
      weights from --seed otherwise, a smoke of the serving PATH, never of
      a served model), serve a handful of synthetic prompts through the
      request queue and its worker thread, and print the generated tokens.

Telemetry as in the JAX package: ``--output-dir`` (default
``./serving_out``) receives ``telemetry_rank0.jsonl`` (the requests'
``queue_wait``, the engine's ``prefill`` and ``decode`` spans, the
shutdown ``drain``) unless ``--no-telemetry``, and a ``flight_*.json`` on
an abnormal exit; ``--metrics-port`` serves ``/metrics`` and
``/healthz``.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the CPU and is meant for the tests. ``bench``, ``serve``,
``fleet`` and ``--mesh`` exist in the JAX package and are refused here
until the slice that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import telemetry
from ..runtime import not_ported

# what the JAX package's serving CLI has and this port refuses, and the
# slice (ROADMAP.md, queue 1) that brings each
_LATER = {
    "bench": "the continuous-serving slice (with the port's benchmark)",
    "serve": "the continuous-serving slice",
    "fleet": "the continuous-serving slice",
    "--mesh": "the tensor-parallel slice",
}


def _parse_buckets(text: str) -> tuple:
    try:
        out = tuple(int(b) for b in text.split(",") if b.strip())
    except ValueError:
        out = ()
    if not out:
        raise SystemExit(f"serving: --buckets expects e.g. '16,32,64', "
                         f"got {text!r}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serving", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["smoke", "bench", "serve", "fleet"])
    p.add_argument("--model", default="gpt2_124m")
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the newest manifest-verified checkpoint "
                        "from this directory (omit: random-init smoke)")
    p.add_argument("--optimizer", default="auto",
                   choices=["auto", "sgd", "adamw"],
                   help="the training run's optimizer, for the restore "
                        "template (auto: adamw, the LMs' recipe)")
    p.add_argument("--zero1", action="store_true",
                   help="the checkpoint was written under --zero1")
    p.add_argument("--fsdp-explicit", action="store_true",
                   help="the checkpoint was written under --fsdp-explicit "
                        "(its flat-padded parameters are unflattened)")
    p.add_argument("--serve-dtype", default="fp32",
                   choices=["fp32", "bf16", "int8"],
                   help="bf16 computes in bf16 beside float32 weights")
    p.add_argument("--mesh", default=None, help="not ported yet (refused)")
    p.add_argument("--buckets", default="16,32",
                   help="prompt-length bucket ladder, e.g. '32,64,128'")
    p.add_argument("--rows", type=int, default=8,
                   help="batch rows per engine cycle")
    p.add_argument("--max-new-tokens", type=int, default=8)
    p.add_argument("--model-overrides", default="",
                   help="architecture overrides, e.g. "
                        "'hidden_dim=64,depth=2,num_heads=2'")
    p.add_argument("--prompt", default=None,
                   help="smoke: comma-separated token ids")
    p.add_argument("--prompt-len", type=int, default=12,
                   help="smoke: synthetic prompt length when no --prompt")
    p.add_argument("--output-dir", default="./serving_out",
                   help="telemetry stream + flight directory")
    p.add_argument("--no-telemetry", action="store_true")
    p.add_argument("--metrics-port", default=None, type=int,
                   help="serve live /metrics + /healthz on this port; "
                        "default DPT_METRICS_PORT env, else off (no "
                        "thread)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cuda:N; 'cpu' runs the plain "
                        "versions of the kernels, for the tests")
    return p


def refusal(args) -> Optional[str]:
    """The message refusing what this port does not run yet, else None."""
    for key, given in (("--mesh", args.mesh),
                       (args.command, args.command != "smoke")):
        if given:
            return f"serving: {not_ported(key, _LATER[key])}"
    return None


@dataclasses.dataclass
class SmokeReport:
    """What one smoke run served: the engine, the prompts, the results."""

    engine: object
    prompts: List[np.ndarray]
    results: list


def smoke(args) -> SmokeReport:
    """Build the engine and serve the smoke prompts through the request
    queue and a worker thread: the production wiring in miniature."""
    from ..experiments.harness import build_serving_engine
    from ..utils.config import parse_model_overrides
    from ..utils.logging import log_main
    from .batching import RequestQueue, drain, serve_forever

    buckets = _parse_buckets(args.buckets)
    overrides = (parse_model_overrides(args.model_overrides)
                 if args.model_overrides else None)
    engine = build_serving_engine(
        args.model, buckets=buckets, rows=args.rows,
        max_new_tokens=args.max_new_tokens, serve_dtype=args.serve_dtype,
        model_overrides=overrides, seed=args.seed, device=args.device,
        ckpt_dir=args.ckpt_dir, optimizer=args.optimizer,
        layout=("fsdp" if args.fsdp_explicit else "zero1" if args.zero1
                else "replicated"))
    if engine.checkpoint_info:
        info = engine.checkpoint_info
        log_main(f"serving: checkpoint label={info['label']} "
                 f"step={info['step']} verified={info['verified']} "
                 f"tree_digest={info['tree_digest']}")
    else:
        log_main(f"serving: NOTE: random-init weights (seed {args.seed}) "
                 f"on {engine.device} — this smokes the serving path, not "
                 "a trained model")

    if args.prompt:
        prompts = [np.asarray([int(t) for t in args.prompt.split(",")],
                              np.int32)]
    else:
        rng = np.random.RandomState(args.seed)
        # the model's own vocab: an id past the table is an error here,
        # where JAX's lookup would clamp it quietly
        vocab = engine.model.vocab_size
        prompts = [rng.randint(0, vocab, n).astype(np.int32)
                   for n in (args.prompt_len, max(args.prompt_len // 2, 1),
                             min(args.prompt_len * 2, max(buckets)))]

    queue = RequestQueue(buckets)
    stop = threading.Event()

    def on_sigterm(signum, frame):
        log_main("serving: SIGTERM — draining the queue, then exiting")
        stop.set()

    prev = signal.signal(signal.SIGTERM, on_sigterm)
    results = []
    try:
        worker = threading.Thread(target=serve_forever,
                                  args=(engine, queue, stop),
                                  kwargs={"log": log_main}, daemon=True)
        worker.start()
        reqs = [queue.submit(p) for p in prompts]
        for req, prm in zip(reqs, prompts):
            res = req.result(timeout=600.0)
            results.append(res)
            log_main(
                f"serving smoke: prompt[{len(prm)} tok] bucket={res.bucket} "
                f"-> {res.tokens.tolist()} (prefill "
                f"{res.prefill_s * 1e3:.1f}ms, decode "
                f"{res.decode_s * 1e3:.1f}ms)")
        stop.set()
        worker.join(timeout=60.0)
        if worker.is_alive():
            raise RuntimeError("serving: the engine worker did not stop")
        # idempotent here (queue already empty): a SIGTERM mid-smoke still
        # completes accepted work before exit
        drain(engine, queue, log=log_main)
    finally:
        signal.signal(signal.SIGTERM, prev)
    log_main(f"serving smoke: ok ({len(results)} requests)")
    return SmokeReport(engine=engine, prompts=prompts, results=results)


def run(argv: Optional[List[str]] = None) -> SmokeReport:
    """Parse ``argv`` as the CLI does, refuse what is not ported (with
    SystemExit, naming the slice that brings it), and run the smoke."""
    args = build_parser().parse_args(argv)
    refused = refusal(args)
    if refused:
        raise SystemExit(refused)
    from ..utils.logging import log_main

    tele_rank = telemetry.rank_identity(0)
    if not args.no_telemetry and telemetry.should_stream(tele_rank):
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        telemetry.configure(
            str(Path(args.output_dir)
                / telemetry.stream_filename(tele_rank)),
            rank=tele_rank, gen=telemetry.generation_identity(),
            meta={"entry": "serving", "model": args.model,
                  "serve_dtype": args.serve_dtype,
                  "buckets": list(_parse_buckets(args.buckets))})
    # live /metrics + /healthz: the prefill/decode spans feed the phase
    # metric and the healthz fence counts their progress; off (the
    # default) starts no thread
    metrics_port = telemetry.resolve_metrics_port(args.metrics_port,
                                                  tele_rank)
    if metrics_port and telemetry.is_configured():
        # None on a bind failure (noted on stderr): the live surface never
        # takes the serving process down
        if telemetry.start_metrics_server(
                metrics_port, telemetry.get(),
                backend="cpu" if args.device == "cpu" else "cuda"
        ) is not None:
            log_main(f"serving: /metrics + /healthz on :{metrics_port}")
    try:
        return smoke(args)
    except BaseException as e:
        # every abnormal serving exit leaves a postmortem flight (the
        # train.py contract); a clean SystemExit(0) is not abnormal
        if not (isinstance(e, SystemExit) and e.code in (0, None)):
            telemetry.flush_flight(
                cause=f"{type(e).__name__}: {e}",
                detail="serving abnormal exit",
                rc=e.code if isinstance(e, SystemExit) else 1)
        raise
    finally:
        # a run without --metrics-port never imported metrics_http
        if f"{telemetry.__name__}.metrics_http" in sys.modules:
            telemetry.stop_metrics_server()
        telemetry.reset()


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
