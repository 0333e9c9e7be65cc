"""Pipeline parallelism over the mesh's ``pipe`` axis (the JAX package's
parallel/pipeline.py): a GPipe schedule, one process a stage.

Schedule: classic GPipe. The local batch splits into M microbatches
(contiguous rows, as JAX's reshape); at tick t, stage p computes
microbatch ``t - p`` (valid when 0 <= t - p < M), so the pipeline fills
for P-1 ticks, streams, and drains for P-1 ticks: bubble fraction
(P-1)/(M+P-1). After every tick but the last the activations rotate one
stage on (``collectives.ppermute_ring``, i -> i+1), and at the end the
last stage's microbatches are broadcast to every stage by one masked sum
over ``pipe`` (JAX's ``psum`` of ``where(p == n-1, outs, 0)``), so the
head and the loss downstream are the same on every stage.

JAX differentiates its ``lax.scan`` over the ticks; here the schedule is
one autograd Function (`_GPipe`) whose backward runs the reverse schedule
by hand, because an eager stage skips the compute of its fill and drain
ticks (their outputs are never read) and autograd alone would then run
the backward rotations on some stages and not on others. Every stage
makes the same collectives in the same order, forward (M+P-2 rotations,
one masked sum) and backward (M+P-2 reverse rotations, one sum):

* the broadcast's backward takes the output's cotangent on the last
  stage only. Each stage computes the same loss from the same broadcast
  outputs, so every stage's cotangent is the whole one and no sum over
  ``pipe`` belongs there (megatron's ``g`` at a region's output);
* a stage's input gradient is summed over ``pipe`` (megatron's ``f`` at a
  region's input): only stage 0 reads the injected microbatches, and the
  sum hands its gradient to every stage, so the embeddings upstream get
  the same, whole gradient on every stage, as do the final LayerNorm and
  the head downstream. No gradient of a replicated leaf is summed over
  ``pipe`` after the step, and none counts P times.

A stage's layers run inside the forward with their graph kept (with
``remat``, only each layer's input, as the model's ``remat_call`` keeps
it); the backward calls ``torch.autograd.grad`` on each valid tick's
graph, from the last tick to the first.

``stack_to_stages`` reshapes (L, ...) layer stacks to (P, L/P, ...),
``sequential_apply`` is the reference semantics (the layers in order),
and at P = 1 ``pipeline_apply`` is that plain loop over the merged
(P L/P, ...) stack, as JAX's degenerate branch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

from .collectives import TpAxis, _sum_over, ppermute_ring

Params = Mapping[str, torch.Tensor]
ApplyLayer = Callable[[Dict[str, torch.Tensor], torch.Tensor],
                      torch.Tensor]


def stack_to_stages(stacked: Params, num_stages: int
                    ) -> Dict[str, torch.Tensor]:
    """(L, ...) layer stacks -> (P, L/P, ...) stage-major stacks (the
    leading axis splits over ``pipe``); JAX's message when L does not
    divide."""
    out = {}
    for name, leaf in stacked.items():
        n = leaf.shape[0]
        if n % num_stages:
            raise ValueError(
                f"{n} layers not divisible into {num_stages} pipeline "
                "stages")
        out[name] = leaf.reshape(num_stages, n // num_stages,
                                 *leaf.shape[1:])
    return out


def _layer(params: Mapping[str, List[torch.Tensor]], j: int
           ) -> Dict[str, torch.Tensor]:
    return {name: layers[j] for name, layers in params.items()}


def sequential_apply(apply_layer: ApplyLayer, stacked: Params,
                     x: torch.Tensor) -> torch.Tensor:
    """Reference semantics: the same layers ((L, ...) leaves), applied in
    order without a pipeline."""
    layers = {name: leaf.unbind(0) for name, leaf in stacked.items()}
    n = len(next(iter(layers.values())))
    for j in range(n):
        x = apply_layer(_layer(layers, j), x)
    return x


def _run_stage(apply_layer: ApplyLayer, names, leaves, h):
    """This stage's layers on ``h``: ``leaves`` are its (1, L/P, ...)
    stacks in ``names`` order (unbound per call, so the backward stacks
    each leaf's layer gradients once)."""
    return sequential_apply(
        apply_layer, {name: leaf[0] for name, leaf in zip(names, leaves)},
        h)


class _GPipe(torch.autograd.Function):
    """The GPipe schedule over ``pipe`` (see the module docstring):
    inputs ``x`` (B, ...) and this stage's (1, L/P, ...) leaves, output
    the broadcast (B, ...) outputs of the last stage."""

    @staticmethod
    def forward(ctx, apply_layer, names, pipe, m, keep, x, *leaves):
        n, p = pipe.size, pipe.index
        b = x.shape[0]
        mb = x.reshape(m, b // m, *x.shape[1:])
        live = [leaf.detach().requires_grad_(leaf.requires_grad)
                for leaf in leaves]
        state = torch.zeros_like(mb[0])
        outs = torch.zeros_like(mb)
        ticks = []
        for t in range(m + n - 1):
            mi = t - p
            y = None
            if 0 <= mi < m:
                h = mb[mi] if p == 0 else state
                if keep:
                    h = h.detach().requires_grad_()
                    with torch.enable_grad():
                        y = _run_stage(apply_layer, names, live, h)
                    ticks.append((t, h, y))
                else:
                    y = _run_stage(apply_layer, names, leaves, h)
                if p == n - 1:
                    outs[mi] = y.detach()
            if t < m + n - 2:
                # every stage rotates every tick but the last; a skipped
                # tick sends zeros nobody reads
                state = ppermute_ring(
                    y.detach() if y is not None else torch.zeros_like(state),
                    pipe.group)
        outs = _sum_over(outs if p == n - 1 else torch.zeros_like(outs),
                         pipe.group)
        ctx.pipe, ctx.m, ctx.ticks, ctx.live = pipe, m, ticks, live
        ctx.mb_shape = mb.shape
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        pipe, m, live = ctx.pipe, ctx.m, ctx.live
        n, p = pipe.size, pipe.index
        g_mb = g_out.reshape(ctx.mb_shape)
        g_x = torch.zeros(ctx.mb_shape, dtype=g_out.dtype,
                          device=g_out.device)
        g_leaves: List[Optional[torch.Tensor]] = [None] * len(live)
        want = [leaf.requires_grad for leaf in live]
        by_tick = {t: (h, y) for t, h, y in ctx.ticks}
        g_recv = None
        for t in range(m + n - 2, -1, -1):
            mi = t - p
            g_h = None
            if t in by_tick:
                h, y = by_tick.pop(t)
                g_y = g_mb[mi] if p == n - 1 else g_recv
                inputs = [h] + [lv for lv, w in zip(live, want) if w]
                grads = torch.autograd.grad(y, inputs, g_y.to(y.dtype),
                                            allow_unused=True)
                g_h = grads[0]
                it = iter(grads[1:])
                for i, w in enumerate(want):
                    if not w:
                        continue
                    g = next(it)
                    if g is not None:
                        g_leaves[i] = g if g_leaves[i] is None \
                            else g_leaves[i] + g
                if p == 0:
                    g_x[mi] = g_h
            if t > 0:
                # the cotangent of stage p's input at tick t is that of
                # stage p-1's output at tick t-1
                send = g_h if (g_h is not None and p > 0) \
                    else torch.zeros(ctx.mb_shape[1:], dtype=g_out.dtype,
                                     device=g_out.device)
                g_recv = ppermute_ring(send.to(g_out.dtype), pipe.group,
                                       -1)
        ctx.ticks = ctx.live = None
        g_x = _sum_over(g_x, pipe.group)
        g_leaves = [torch.zeros_like(lv) if g is None and w else g
                    for g, lv, w in zip(g_leaves, live, want)]
        return (None, None, None, None, None, g_x.reshape(g_out.shape),
                *g_leaves)


def pipeline_apply(apply_layer: ApplyLayer, stage_params: Params,
                   x: torch.Tensor, pipe: Optional[TpAxis],
                   num_microbatches: int) -> torch.Tensor:
    """Run a stage-stacked layer sequence as a GPipe pipeline.

    Args:
      apply_layer: ``(layer_params, x) -> y`` for ONE layer (its leaves,
        unstacked, by name).
      stage_params: this stage's leaves, (1, L/P, ...) each: its slice of
        the (P, L/P, ...) stacks (`stack_to_stages`); with a ``pipe`` of
        one stage, every stage's, (P, L/P, ...).
      x: (B, ...) activations, the same on every stage.
      pipe: the ``pipe`` axis (``Mesh.axis_shard``); None or size 1 runs
        the merged stack as a plain loop.
      num_microbatches: M; the local batch must divide by it.

    Returns (B, ...) outputs, the same on every stage, equal (up to
    float reassociation) to applying all P L/P layers in order."""
    names = sorted(stage_params)
    if pipe is None or pipe.size == 1:
        merged = {name: stage_params[name].reshape(
            -1, *stage_params[name].shape[2:]) for name in names}
        return sequential_apply(apply_layer, merged, x)
    b, m = x.shape[0], num_microbatches
    if b % m:
        raise ValueError(
            f"local batch {b} not divisible into {m} microbatches")
    leaves = [stage_params[name] for name in names]
    # the graph of each tick is kept only when a backward can follow
    keep = torch.is_grad_enabled() and (
        x.requires_grad or any(leaf.requires_grad for leaf in leaves))
    return _GPipe.apply(apply_layer, tuple(names), pipe, m, keep, x,
                        *leaves)
