"""Batched inference: the dense engine, the continuous slot engine over the
paged KV pool, speculative decoding, the router and the CLI.

Two batching disciplines share the stack. The iteration-granular path
(`InferenceEngine` + `serve_forever`) forms a batch, decodes it to the
end, forms the next. The token-granular path (`SlotEngine` +
`ContinuousScheduler`) keeps one decode step running over a fixed slot
pool backed by a paged, optionally int8, KV pool (`PagedServeConfig`,
`PagePool`), admitting and retiring requests between tokens. `Router`
spreads requests over replicas and resubmits on a replica's death with
the request's sampling seed pinned.
"""

from .batching import Request, RequestQueue, Result, drain, serve_forever
from .continuous import (
    ContinuousScheduler,
    SlotEngine,
    sample_tokens,
    serve_continuous,
)
from .engine import (
    InferenceEngine,
    QuantizedLeaf,
    ServeConfig,
    dequantize_params,
    int8_weight_bytes,
    quantize_params,
)
from ..models.layers import dense_kv_bytes, paged_kv_bytes
from .paged import PagedServeConfig, PagePool
from .router import (
    HttpReplica,
    InProcessReplica,
    ReplicaDead,
    Router,
    RouterRequest,
)
from .speculative import SpeculativeEngine, SpeculativeScheduler

__all__ = [
    "ContinuousScheduler", "HttpReplica", "InProcessReplica",
    "InferenceEngine", "PagePool", "PagedServeConfig", "QuantizedLeaf",
    "ReplicaDead", "Request", "RequestQueue", "Result", "Router",
    "RouterRequest", "ServeConfig", "SlotEngine", "SpeculativeEngine",
    "SpeculativeScheduler", "dense_kv_bytes", "dequantize_params", "drain",
    "int8_weight_bytes", "paged_kv_bytes", "quantize_params",
    "sample_tokens", "serve_continuous", "serve_forever",
]
