"""``python -m distributed_pytorch_training_tpu_torch.serving`` — the
batched and the continuous inference engines on the GPU.

Commands:
  smoke [--ckpt-dir D [--zero1 | --fsdp-explicit]]
        [--prompt 12,7,99 | --prompt-len N] [--serve-dtype fp32|bf16|int8]
      Build the engine (restoring the newest manifest-verified checkpoint
      under --ckpt-dir, written under the given update mode, and logging
      its label and tree digest; random-init
      weights from --seed otherwise, a smoke of the serving PATH, never of
      a served model), serve a handful of synthetic prompts through the
      request queue and its worker thread, and print the generated tokens
      (a token model that is not an LM, bert_base, generates none). An
      image model (resnet18, resnet50, vit_b16) serves two uint8 32x32
      images drawn from --seed, normalized with CIFAR-10's statistics,
      and prints the logits' shape and top-1.
  bench [--requests N] [--offered-load RPS] [--mixed-want] [--json]
      Latency and throughput at fixed offered load: a seeded load
      generator submits mixed-length prompts on a 1/RPS cadence while the
      engine drains the queue; reports p50/p99 latency and the achieved
      request and token rates (experiments/harness.py::measure_serving;
      token models only, and no token rate for bert_base).
      --continuous runs the token-granular arm instead (slot engine over
      the paged KV pool, serving/continuous.py) on the same schedule:
      --kv-dtype int8 quantizes its pages (K1 on every page write),
      --page-size sets the page; --replicas N puts N replicas behind the
      router and --kill-replica kills one mid-load (every request must
      still complete); --draft MODEL arms speculative decoding (--draft-k
      proposals a round; fp32 pages); --shared-frac F gives F of the
      requests one shared prompt (admitted with no prefill after the
      first); --no-prefix-skip turns that fast path off.
  serve [--port P] [--kv-dtype int8] [--page-size N]
      One long-lived continuous replica (causal LMs only): POST /generate ({"tokens": [...],
      "max_new_tokens"?, "temperature"?, "top_p"?, "seed"?,
      "want_logits"?}) answers when the tokens are out; GET /healthz on
      the same port; /metrics and /healthz on --metrics-port. --port 0
      takes an ephemeral port (logged). SIGTERM drains: admitted requests
      complete, then the process exits 0.

Telemetry as in the JAX package: ``--output-dir`` (default
``./serving_out``) receives ``telemetry_rank0.jsonl`` (the requests'
``queue_wait``, the engine's ``prefill`` and ``decode`` spans, the
continuous engine's ``slot_wait`` and ``router_dispatch`` spans and slot
and page gauges, the shutdown ``drain``) unless ``--no-telemetry``, and a
``flight_*.json`` on an abnormal exit; ``--metrics-port`` serves
``/metrics`` and ``/healthz``.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the CPU and is meant for the tests. ``fleet`` and ``--mesh``
exist in the JAX package and are refused here until the slices that port
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    "fleet": "the operations slice (resilience/fleet.py and the "
             "Deathwatch)",
    "--mesh": "the serving --mesh slice (ROADMAP queue 1, after TP)",
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
                        "template (auto: adamw for the LMs, sgd for the "
                        "vision models)")
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
    # continuous / paged serving (serve, bench --continuous)
    p.add_argument("--continuous", action="store_true",
                   help="bench: the token-granular slot-engine arm (paged "
                        "KV) instead of the iteration-granular engine")
    p.add_argument("--replicas", type=int, default=1,
                   help="bench --continuous: in-process replicas behind "
                        "the router")
    p.add_argument("--kv-dtype", default="fp32", choices=["fp32", "int8"],
                   help="paged KV pool dtype (int8: per-row quantized "
                        "pages on the gradient wire's grid)")
    p.add_argument("--page-size", type=int, default=8,
                   help="positions per KV page")
    p.add_argument("--kill-replica", action="store_true",
                   help="bench --continuous --replicas>1: kill replica 0 "
                        "mid-load; the router resubmits its requests")
    p.add_argument("--draft", default=None, metavar="MODEL",
                   help="bench --continuous: speculative decoding with "
                        "this random-init draft LM (fp32 KV only)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="draft tokens proposed a slot a verify round")
    p.add_argument("--shared-frac", type=float, default=0.0,
                   help="bench --continuous: share of the requests that "
                        "carry one page-aligned prompt")
    p.add_argument("--no-prefix-skip", action="store_true",
                   help="no prefix-resident admission (shared pages still "
                        "dedupe; admission prefills)")
    p.add_argument("--port", type=int, default=8100,
                   help="serve: the /generate port (0 = ephemeral, "
                        "logged)")
    # bench
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--offered-load", type=float, default=16.0,
                   help="bench: offered request rate (req/s)")
    p.add_argument("--mixed-want", action="store_true",
                   help="bench: per-request decode lengths (1..max_new, "
                        "seeded); the iteration arm still decodes max_new "
                        "a batch and credits only the wanted tokens")
    p.add_argument("--json", action="store_true", dest="as_json")
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
                       (args.command, args.command == "fleet")):
        if given:
            return f"serving: {not_ported(key, _LATER[key])}"
    return None


# what an image model's smoke serves: two uint8 32x32 images from --seed,
# normalized with CIFAR-10's mean and std as the JAX serving CLI rounds
# them (data/datasets.py's CIFAR10_STD keeps four digits)
SMOKE_IMAGES = (2, 32, 32, 3)
SMOKE_IMAGE_MEAN = (0.4914, 0.4822, 0.4465)
SMOKE_IMAGE_STD = (0.247, 0.243, 0.262)


@dataclasses.dataclass
class SmokeReport:
    """What one smoke run served: the engine, the prompts (an image
    model's images) and the results (an image model's logits)."""

    engine: object
    prompts: List[np.ndarray]
    results: list


def _engine_kwargs(args) -> dict:
    """The engine factories' arguments every command shares."""
    from ..utils.config import parse_model_overrides

    return dict(
        buckets=_parse_buckets(args.buckets), rows=args.rows,
        max_new_tokens=args.max_new_tokens, serve_dtype=args.serve_dtype,
        model_overrides=(parse_model_overrides(args.model_overrides)
                         if args.model_overrides else None),
        seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
        optimizer=args.optimizer,
        layout=("fsdp" if args.fsdp_explicit else "zero1" if args.zero1
                else "replicated"))


def smoke(args) -> SmokeReport:
    """Build the engine and serve the smoke prompts through the request
    queue and a worker thread: the production wiring in miniature."""
    from ..experiments.harness import build_serving_engine
    from ..utils.logging import log_main
    from .batching import RequestQueue, drain, serve_forever

    buckets = _parse_buckets(args.buckets)
    engine = build_serving_engine(args.model, **_engine_kwargs(args))
    if engine.checkpoint_info:
        info = engine.checkpoint_info
        log_main(f"serving: checkpoint label={info['label']} "
                 f"step={info['step']} verified={info['verified']} "
                 f"tree_digest={info['tree_digest']}")
    else:
        log_main(f"serving: NOTE: random-init weights (seed {args.seed}) "
                 f"on {engine.device} — this smokes the serving path, not "
                 "a trained model")

    if not engine.is_token:
        rng = np.random.RandomState(args.seed)
        images = rng.randint(0, 256, SMOKE_IMAGES).astype(np.uint8)
        logits = engine.serve_images(images, mean=SMOKE_IMAGE_MEAN,
                                     std=SMOKE_IMAGE_STD)
        log_main(f"serving smoke: {logits.shape[0]} images -> logits "
                 f"{logits.shape}, top-1 {logits.argmax(-1).tolist()}")
        return SmokeReport(engine=engine, prompts=list(images),
                           results=list(logits))

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


def bench(args) -> dict:
    """The serving row at fixed offered load: iteration-granular, or
    token-granular with ``--continuous``. Prints it as JSON with
    ``--json``, else as one log line; returns it."""
    from ..experiments.harness import (
        measure_serving, measure_serving_continuous,
    )
    from ..utils.logging import log_main

    common = dict(model_name=args.model, n_requests=args.requests,
                  offered_rps=args.offered_load, mixed_want=args.mixed_want,
                  **_engine_kwargs(args))
    if args.continuous:
        row = measure_serving_continuous(
            kv_dtype=args.kv_dtype, page_size=args.page_size,
            replicas=args.replicas, kill_replica=args.kill_replica,
            draft_model=args.draft, draft_k=args.draft_k,
            shared_frac=args.shared_frac,
            prefix_skip=not args.no_prefix_skip, **common)
    else:
        row = measure_serving(**common)
    if args.as_json:
        print(json.dumps(row, sort_keys=True, default=str), flush=True)
    elif args.continuous:
        spec = (f", draft={row['draft']} k={row['draft_k']} accept "
                f"{row['accept_ratio']} ({row['accepted_per_verify']} "
                "tok/verify)" if row.get("draft") else "")
        skip = (f", {row['prefill_skips']} prefill skips / "
                f"{row['tail_resumes']} tail resumes"
                if row["prefill_skips"] or row["tail_resumes"] else "")
        log_main(
            f"serving bench [token-granular x{row['replicas']}]: "
            f"{row['model']} kv={row['kv_dtype']} p50 {row['p50_ms']}ms "
            f"p99 {row['p99_ms']}ms ttft p50 {row['ttft_p50_ms']}ms at "
            f"{row['achieved_rps']}/{row['offered_rps']} req/s "
            f"({row['tokens_per_sec']} tok/s), KV {row['paged_kv_bytes']}B "
            f"vs dense {row['dense_kv_bytes']}B ({row['kv_bytes_ratio']}x),"
            f" {row['completed']}/{row['n_requests']} completed, "
            f"{row['replica_deaths']} replica deaths" + spec + skip)
    else:
        toks = (f" ({row['tokens_per_sec']} tok/s)"
                if "tokens_per_sec" in row else "")
        log_main(
            f"serving bench: {row['model']} [{row['serve_dtype']}] p50 "
            f"{row['p50_ms']}ms p99 {row['p99_ms']}ms at "
            f"{row['achieved_rps']}/{row['offered_rps']} req/s{toks}")
    return row


def serve(args) -> int:
    """One long-lived continuous replica behind stdlib HTTP: POST
    /generate blocks its handler thread on the request's result (each
    request has its own thread; the scheduler's worker is the one engine
    caller). SIGTERM drains, then the process exits 0."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..experiments.harness import build_slot_engine
    from ..utils.logging import log_main
    from .batching import RequestQueue
    from .continuous import ContinuousScheduler

    engine = build_slot_engine(args.model, kv_dtype=args.kv_dtype,
                               page_size=args.page_size,
                               prefix_skip=not args.no_prefix_skip,
                               **_engine_kwargs(args))
    engine.warmup()
    log_main(f"serving: slot engine ready on {engine.device}, "
             f"kv={args.kv_dtype} pages of {args.page_size} "
             f"({engine.paged_bytes()}B paged vs "
             f"{engine.dense_baseline_bytes()}B dense)")
    queue = RequestQueue(engine.config.buckets)
    sched = ContinuousScheduler(engine, queue)
    stop = threading.Event()
    worker = threading.Thread(target=sched.run, args=(stop,),
                              kwargs={"log": log_main}, daemon=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # request logging rides telemetry
            pass

        def _reply(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                # the metrics port's /healthz is the step-fence verdict;
                # this one answers 'is the replica accepting'
                self._reply(200 if not stop.is_set() else 503,
                            {"draining": stop.is_set(),
                             "served": sched.served})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n).decode() or "{}")
                tokens = np.asarray(body["tokens"], np.int32)
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                req = queue.submit(
                    tokens, max_new_tokens=body.get("max_new_tokens"),
                    temperature=float(body.get("temperature", 0.0)),
                    top_p=float(body.get("top_p", 1.0)),
                    seed=body.get("seed"))
                res = req.result(timeout=600.0)
            except Exception as e:  # noqa: BLE001 - one request, one reply
                self._reply(503, {"error": f"{type(e).__name__}: {e}"})
                return
            out = {"tokens": res.tokens.tolist(), "bucket": res.bucket,
                   "queue_wait_ms": round(res.queue_wait_s * 1e3, 3),
                   "decode_ms": round(res.decode_s * 1e3, 3)}
            if body.get("want_logits"):
                out["last_logits"] = [float(v) for v in res.last_logits]
            self._reply(200, out)

    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    port = httpd.server_address[1]

    def on_sigterm(signum, frame):
        log_main("serving: SIGTERM — draining the slot pool, then exiting")
        stop.set()

    prev = signal.signal(signal.SIGTERM, on_sigterm)
    worker.start()
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    log_main(f"serving: POST /generate on :{port} — SIGTERM drains")
    try:
        while not stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        stop.set()
    finally:
        signal.signal(signal.SIGTERM, prev)
        queue.close()
        worker.join(timeout=600.0)
        httpd.shutdown()
        httpd.server_close()
    telemetry.flush_flight(cause="sigterm drain",
                           detail="serving replica graceful shutdown",
                           rc=0)
    log_main(f"serving: replica drained ({sched.served} served)")
    return 0


def run(argv: Optional[List[str]] = None):
    """Parse ``argv`` as the CLI does, refuse what is not ported (with
    SystemExit, naming the slice that brings it), and run the command:
    smoke returns its `SmokeReport`, bench its row, serve its exit
    code."""
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
        return {"smoke": smoke, "bench": bench,
                "serve": serve}[args.command](args)
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
    out = run(argv)
    if isinstance(out, dict):      # bench: every request must complete
        return 0 if out.get("completed", out["n_requests"]) == \
            out["n_requests"] else 1
    return out if isinstance(out, int) else 0


if __name__ == "__main__":
    sys.exit(main())
