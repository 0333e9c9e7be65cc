"""The port's trace readers (``experiments/trace_analysis.py`` on
``torch.profiler``'s Chrome trace) against the JAX package's (on an XLA
trace).

Each case writes one hand-built trace in the shape ``torch.profiler``
writes (the event categories, pids, tids and names below were read off
traces taken on an NVIDIA H100: CUPTI's ``kernel`` / ``gpu_memcpy`` /
``gpu_memset`` events on pid = device, tid = stream; gloo's
``gloo:<op>`` ``user_annotation`` on its ``pt_gloo_runloop`` thread; the
``c10d::`` call on the caller's thread; the staging copies matched to
their ``cudaMemcpyAsync`` by CUPTI's correlation id) and its pair in the
shape ``jax.profiler`` writes, with the same intervals. The port's
``collective_share``, ``comm_overlap_split`` and ``device_time_split``
must give exactly the dicts the JAX readers give. Times are whole
microseconds, so every sum is exact in float64 and the comparisons are
exact. A hypothesis property holds the four-way identity
(compute + hidden + exposed + gap == window) and the JAX pairing on
random intervals.
"""

import gzip
import json

import pytest
from hypothesis import given, settings, strategies as st

from distributed_pytorch_training_tpu.experiments import (
    trace_analysis as jta,
)
from distributed_pytorch_training_tpu_torch.experiments import (
    trace_analysis as pta,
)

HOST = 258          # the profiled process's pid
MAIN, AUTOGRAD, GLOO = 258, 270, 267   # its threads
DEVICE = 0          # CUPTI's pid of the card
# kernel names as the card's traces show them
FLASH_FWD = ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>("
             "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
             "const*, float const*, __nv_bfloat16*, float*, int, int, int, "
             "int, (anonymous namespace)::Strides, (anonymous namespace)::"
             "Strides, (anonymous namespace)::Strides, float, int, int)")
GEMM = ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas")
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")
# NCCL's kernels, one per by_op key, as a trace of torch 2.11's NCCL on
# four H100s names them
NCCL = {
    "all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "all-gather": "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "reduce-scatter": "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "collective-permute": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
}
D2H = "Memcpy DtoH (Device -> Pinned)"
H2D = "Memcpy HtoD (Pinned -> Device)"


# -- trace writers ------------------------------------------------------------


def _meta():
    return [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": DEVICE, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": DEVICE, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": HOST, "tid": GLOO,
         "args": {"name": f"thread {GLOO} (pt_gloo_runloop)"}},
        {"ph": "M", "name": "thread_name", "pid": DEVICE, "tid": 7,
         "args": {"name": "stream 7 "}},
        # the profiler's own span and the [memory] instants: bookkeeping
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": -50.0,
         "dur": 10_000.0, "args": {"Op count": 0}},
        {"ph": "i", "cat": "cpu_instant_event", "name": "[memory]",
         "pid": HOST, "tid": MAIN, "ts": 3.0, "s": "t",
         "args": {"Bytes": 512}},
    ]


def device(cat, name, stream, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": DEVICE,
            "tid": stream, "ts": float(ts), "dur": float(dur),
            "args": {"device": 0, "stream": stream, "correlation": corr}}


def host(cat, name, tid, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": HOST, "tid": tid,
          "ts": float(ts), "dur": float(dur), "args": {}}
    if corr is not None:
        ev["args"]["correlation"] = corr
    return ev


def write_torch(d, events, name="vm_258.1792243078030.pt.trace.json",
                gz=False):
    d.mkdir(parents=True, exist_ok=True)
    body = {"schemaVersion": 1, "traceEvents": _meta() + events}
    if gz:
        with gzip.open(d / (name + ".gz"), "wt") as f:
            json.dump(body, f)
    else:
        (d / name).write_text(json.dumps(body))
    return str(d)


def write_xla(d, events, device_lanes=True):
    """The JAX reader's input: (name, pid, tid, ts, dur) on one device's
    "XLA Ops" lane, or (``device_lanes=False``) on host threads."""
    trace = []
    if device_lanes:
        trace += [{"ph": "M", "pid": 7, "name": "process_name",
                   "args": {"name": "/device:GPU:0"}},
                  {"ph": "M", "pid": 7, "tid": 1, "name": "thread_name",
                   "args": {"name": "XLA Ops"}}]
    for name, tid, ts, dur in events:
        trace.append({"ph": "X", "pid": 7 if device_lanes else 1,
                      "tid": 1 if device_lanes else tid, "name": name,
                      "ts": float(ts), "dur": float(dur)})
    out = d / "plugins" / "profile" / "2026_10_17"
    out.mkdir(parents=True)
    with gzip.open(out / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": trace}, f)
    return str(d)


READERS = ("collective_share", "comm_overlap_split", "device_time_split")


def assert_same(tmp_path, torch_events, xla_events, device_lanes=True,
                gz=False):
    ours = write_torch(tmp_path / "torch", torch_events, gz=gz)
    theirs = write_xla(tmp_path / "xla", xla_events, device_lanes)
    out = {}
    for reader in READERS:
        got = getattr(pta, reader)(ours)
        assert got == getattr(jta, reader)(theirs), reader
        out[reader] = got
    s = out["device_time_split"]
    assert (s["compute_us"] + s["comm_hidden_us"] + s["comm_exposed_us"]
            + s["host_gap_us"]) == s["window_us"]
    return out


# -- paired cases -------------------------------------------------------------


def test_kernel_lanes_on_two_streams_and_nccl(tmp_path):
    """Compute on streams 7 and 20 (overlapping: one union), an NCCL
    all-reduce on stream 30 half under them, a memset and a copy, and a
    host gap."""
    torch_events = [
        device("kernel", GEMM, 7, 0, 100),
        device("kernel", FLASH_FWD, 20, 40, 100),        # overlaps stream 7
        device("kernel", NCCL["all-reduce"], 30, 120, 60),
        device("gpu_memset", "Memset (Device)", 7, 300, 4),
        device("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 7, 310, 20),
        device("kernel", ADD, 7, 400, 50),
        host("cpu_op", "aten::mm", MAIN, 0, 30),   # host ops: not device
        host("cuda_runtime", "cudaLaunchKernel", MAIN, 5, 8, corr=1),
    ]
    xla_events = [("fusion.1", 1, 0, 100), ("fusion.2", 1, 40, 100),
                  ("all-reduce.3", 1, 120, 60), ("fusion.4", 1, 300, 4),
                  ("copy.5", 1, 310, 20), ("fusion.6", 1, 400, 50)]
    out = assert_same(tmp_path, torch_events, xla_events)
    s = out["device_time_split"]
    assert s["window_us"] == 450.0
    assert s["comm_hidden_us"] == 20.0 and s["comm_exposed_us"] == 40.0
    assert s["by_op"] == {"all-reduce": 60.0}
    assert s["n_device_lanes"] == 1


def test_nccl_ops_and_the_all_to_all_annotation(tmp_path):
    """Each NCCL kernel keys onto its by_op name; a SendRecv kernel inside
    ProcessGroupNCCL's ``nccl:all_to_all`` annotation is an all-to-all."""
    torch_events = [
        device("kernel", GEMM, 7, 0, 50),
        device("kernel", NCCL["all-gather"], 13, 10, 30),
        device("kernel", NCCL["reduce-scatter"], 13, 60, 30),
        device("kernel", NCCL["collective-permute"], 13, 100, 10),
        device("gpu_user_annotation", "nccl:all_to_all", 13, 120, 40),
        device("kernel", NCCL["collective-permute"], 13, 125, 30),
        # a batch_isend_irecv: its SendRecv stays a collective-permute
        device("gpu_user_annotation", "nccl:coalesced", 19, 165, 20),
        device("kernel", NCCL["collective-permute"], 19, 170, 10),
        device("kernel", ADD, 7, 200, 10),
    ]
    xla_events = [("fusion.1", 1, 0, 50), ("all-gather.2", 1, 10, 30),
                  ("reduce-scatter.3", 1, 60, 30),
                  ("collective-permute.4", 1, 100, 10),
                  ("all-to-all.5", 1, 125, 30),
                  ("collective-permute.6", 1, 170, 10),
                  ("fusion.7", 1, 200, 10)]
    out = assert_same(tmp_path, torch_events, xla_events)
    assert out["collective_share"]["by_op"] == {
        "all-gather": 30.0, "all-to-all": 30.0, "collective-permute": 20.0,
        "reduce-scatter": 30.0}


def test_gloo_host_span_and_its_staging_copies(tmp_path):
    """gloo on CUDA tensors: the ``gloo:all_reduce`` span of the worker
    thread is a collective interval of the card's timeline, and so are
    the copies its ``c10d::allreduce_`` call and the span itself launched
    (matched by correlation id); a copy launched elsewhere, and the
    autograd thread's c10d call around nothing, stay as they are."""
    torch_events = [
        device("kernel", GEMM, 7, 0, 100),
        # c10d::allreduce_ on the autograd thread launches the D2H staging
        host("cpu_op", "c10d::allreduce_", AUTOGRAD, 90, 20),
        host("cuda_runtime", "cudaMemcpyAsync", AUTOGRAD, 95, 5, corr=11),
        device("gpu_memcpy", D2H, 100, 100, 10, corr=11),
        # the worker's span: [110, 400), the H2D copy-back launched in it
        host("user_annotation", "gloo:all_reduce", GLOO, 110, 290),
        host("cuda_runtime", "cudaMemcpyAsync", GLOO, 390, 5, corr=12),
        device("gpu_memcpy", H2D, 104, 395, 15, corr=12),
        # the card's view of that annotation: not a device op
        device("gpu_user_annotation", "gloo:all_reduce", 104, 395, 15),
        # device work under the span (hides part of it), and a copy the
        # main thread launched outside any collective
        device("kernel", ADD, 7, 150, 50),
        host("cuda_runtime", "cudaMemcpyAsync", MAIN, 500, 5, corr=13),
        device("gpu_memcpy", H2D, 7, 505, 5, corr=13),
    ]
    xla_events = [("fusion.1", 1, 0, 100), ("all-reduce.2", 1, 100, 10),
                  ("all-reduce.3", 1, 110, 290),
                  ("all-reduce.4", 1, 395, 15), ("fusion.5", 1, 150, 50),
                  ("copy.6", 1, 505, 5)]
    out = assert_same(tmp_path, torch_events, xla_events, gz=True)
    s = out["device_time_split"]
    assert s["by_op"] == {"all-reduce": 315.0}
    assert s["comm_hidden_us"] == 50.0          # the ADD under the span
    assert s["comm_exposed_us"] == 260.0        # [100, 410) less 50
    assert s["host_gap_us"] == 95.0             # [410, 505)


def test_cpu_trace_nested_host_ops(tmp_path):
    """No device lanes (the tests' backend): the outermost host op of each
    nest counts once (``aten::linear`` holds ``aten::addmm``), the
    profiler's bookkeeping (ProfilerStep#, the session span, [memory])
    is dropped, and the collectives are the c10d call and gloo's span."""
    torch_events = [
        host("user_annotation", "ProfilerStep#3", MAIN, 0, 1000),
        host("cpu_op", "aten::linear", MAIN, 10, 100),
        host("cpu_op", "aten::t", MAIN, 12, 5),
        host("cpu_op", "aten::addmm", MAIN, 20, 80),
        host("cpu_op", "aten::copy_", MAIN, 30, 10),
        host("cpu_op", "c10d::allreduce_", MAIN, 150, 20),
        host("user_annotation", "gloo:all_reduce", GLOO, 160, 100),
        host("cpu_op", "aten::relu", MAIN, 300, 40),
        host("cpu_op", "aten::clamp_min", MAIN, 305, 30),
    ]
    xla_events = [("dot.1", 1, 10, 100), ("all-reduce.2", 1, 150, 20),
                  ("all-reduce.3", 2, 160, 100), ("relu.4", 1, 300, 40)]
    out = assert_same(tmp_path, torch_events, xla_events,
                      device_lanes=False)
    s = out["device_time_split"]
    assert s["window_us"] == 330.0 and s["host_gap_us"] == 80.0
    assert s["by_op"] == {"all-reduce": 120.0}


def test_no_trace_raises_file_not_found(tmp_path):
    (tmp_path / "empty").mkdir()
    for reader in READERS:
        with pytest.raises(FileNotFoundError):
            getattr(pta, reader)(str(tmp_path / "empty"))


def test_launches_without_kernels_raise(tmp_path):
    """A CUDA trace whose runtime launched kernels but which holds none
    (CUPTI recorded no device activity) gives no split: it would read as
    a CPU trace of host ops otherwise."""
    d = write_torch(tmp_path / "t", [
        host("cpu_op", "aten::mm", MAIN, 0, 30),
        host("cuda_runtime", "cudaLaunchKernel", MAIN, 5, 8, corr=1)])
    with pytest.raises(ValueError, match="no kernel event"):
        pta.device_time_split(d)


@pytest.mark.parametrize("name,key", [
    *((name, key) for key, name in NCCL.items()),
    ("ncclKernel_AllReduce_RING_LL_Sum_float(ncclDevComm*, unsigned long, "
     "ncclWork*)", "all-reduce"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "all-reduce"),
    ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "broadcast"),
    ("nccl:_all_gather_base", "all-gather"),
    ("nccl:_reduce_scatter_base", "reduce-scatter"),
    ("nccl:send 0->1", "collective-permute"),
    ("gloo:all_reduce", "all-reduce"), ("gloo:all_gather", "all-gather"),
    ("gloo:all_to_all", "all-to-all"), ("gloo:reduce_scatter",
                                        "reduce-scatter"),
    ("nccl:all_to_all", "all-to-all"), ("c10d::allreduce_", "all-reduce"),
    ("c10d::allgather_", "all-gather"),
    ("c10d::_reduce_scatter_base_", "reduce-scatter"),
    ("c10d::alltoall_base_", "all-to-all"), ("c10d::send", "collective-permute"),
    (GEMM, None), (FLASH_FWD, None), ("aten::all", None),
    ("Memcpy DtoH (Device -> Pinned)", None),
])
def test_collective_keys(name, key):
    assert pta.collective_key(name) == key


@pytest.mark.parametrize("name,op,base", [
    (FLASH_FWD, "flash_fwd_bf16_kernel<64>", "flash_fwd_bf16_kernel"),
    ("void flash_bwd_dq_bf16_kernel<64>(int)", "flash_bwd_dq_bf16_kernel<64>",
     "flash_bwd_dq_bf16_kernel"),
    (ADD, "at::native::vectorized_elementwise_kernel<4, "
          "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >",
     "at::native::vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "at::native::(anonymous namespace)::TensorListMetadata<2>, int>(int)",
     "at::native::multi_tensor_apply_kernel<at::native::TensorListMetadata"
     "<2>, int>", "at::native::multi_tensor_apply_kernel"),
    (GEMM, GEMM, GEMM), ("Memset (Device)",) * 3, (H2D,) * 3,
])
def test_op_and_kernel_base_names(name, op, base):
    assert pta.op_name(name) == op
    assert pta.kernel_base_name(name) == base


def test_top_device_ops(tmp_path):
    d = write_torch(tmp_path / "t", [
        device("kernel", FLASH_FWD, 7, 0, 10),
        device("kernel", FLASH_FWD.replace("(__nv", "(int, __nv"), 7, 20,
               30),
        device("kernel", GEMM, 7, 60, 25),
        device("gpu_memset", "Memset (Device)", 7, 90, 1),
        host("cpu_op", "aten::mm", MAIN, 0, 300)])
    assert pta.top_device_ops(d, n=2) == [
        {"name": "flash_fwd_bf16_kernel<64>", "launches": 2,
         "total_us": 40.0, "mean_us": 20.0},
        {"name": GEMM, "launches": 1, "total_us": 25.0, "mean_us": 25.0}]


# -- the property ---------------------------------------------------------------

_interval = st.tuples(st.integers(0, 400), st.integers(1, 80))


@settings(max_examples=40, deadline=None)
@given(compute=st.lists(st.tuples(st.sampled_from([7, 20]), _interval),
                        min_size=0, max_size=8),
       nccl=st.lists(_interval, max_size=4),
       gloo=st.lists(_interval, max_size=3))
def test_identity_and_pairing_on_random_intervals(tmp_path_factory, compute,
                                                  nccl, gloo):
    """Random kernels on two streams, NCCL all-reduces on a third, gloo
    spans on the host: the four-way identity holds exactly, and the port's
    readers give the JAX readers' dicts on the paired trace."""
    if not compute and not nccl:
        return   # gloo spans alone have no device to sit on
    torch_events, xla_events = [], []
    for i, (stream, (ts, dur)) in enumerate(compute):
        torch_events.append(device("kernel", GEMM, stream, ts, dur))
        xla_events.append((f"fusion.{i}", 1, ts, dur))
    for i, (ts, dur) in enumerate(nccl):
        torch_events.append(device("kernel", NCCL["all-reduce"], 30, ts,
                                   dur))
        xla_events.append((f"all-reduce.{i}", 1, ts, dur))
    for i, (ts, dur) in enumerate(gloo):
        torch_events.append(host("user_annotation", "gloo:all_reduce",
                                 GLOO + i, ts, dur))
        xla_events.append((f"all-reduce.g{i}", 1, ts, dur))
    assert_same(tmp_path_factory.mktemp("case"), torch_events, xla_events)
