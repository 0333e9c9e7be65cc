"""The port's masked-LM draws against jax.random and the JAX package's
MaskedLMTask.

* ``utils/prng.py``'s ``split``, ``bernoulli`` and ``randint`` BITWISE
  ``jax.random``'s (threefry2x32, partitionable: jax 0.9's defaults) on
  several keys and shapes, spans that are not powers of two among them
  (``randint``'s uint32 arithmetic wraps above 2**16), and a block of a
  draw (``offset``) bitwise the same elements of the whole draw.
* ``MaskedLMTask`` on the same key and batch as the JAX task, with the
  same logits function standing in for the model: the model's input ids
  BITWISE, the weight and "correct" sums exactly, the loss and loss sum
  within LOSS_RTOL = 1e-6 (float32 log-softmax on each side); a rank's
  rows of a draw over the global batch BITWISE the matching rows of the
  JAX task's; the Trainer's keys are the JAX steps' (global draws on the
  replicated path, ``fold_in(key, rank)`` on the explicit ones, one split
  a microbatch), and eval draws from ``PRNGKey(0)`` every batch.
* A 3-step trajectory of a narrow BERT (2 blocks, width 64, seq 16) on 2
  gloo ranks against the JAX Trainer on a 2-device CPU mesh: on the
  implicit path with and without accumulation, through the explicit
  fp32 reducer with accumulation, and under ZeRO-1. Each step's weight
  (the masked positions summed over the ranks) exactly, the losses within
  TRAJ_RTOL = 1e-5 and the parameters within PARAM_ATOL = 1e-5 +
  PARAM_RTOL = 1e-4 (float32 reassociation, as in test_torch_dp_gpt2.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.tasks import (
    MaskedLMTask as JaxMLMTask,
)
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig,
    Trainer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    MaskedLMTask,
    StepKey,
)
from distributed_pytorch_training_tpu_torch.utils import prng
from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401

LOSS_RTOL = 1e-6
TRAJ_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
SEEDS = [0, 1, 42, 2 ** 31 + 5]
VOCAB, MASK_ID = 128, 3


def words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


# ---------------------------------------------------------------------------
# jax.random's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_bitwise(seed, num):
    got = prng.split(prng.prng_key(seed), num).numpy()
    want = words(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(got, want)
    # key i of a split is fold_in(key, i) under the partitionable layout
    np.testing.assert_array_equal(got[1], prng.fold_in(
        prng.prng_key(seed), 1).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,p", [((4, 7), 0.15), ((3, 512), 0.15),
                                     ((1,), 0.5), ((33, 9), 0.9)])
def test_bernoulli_bitwise(seed, shape, p):
    got = prng.bernoulli(prng.prng_key(seed), p, int(np.prod(shape)))
    want = jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).ravel())


# spans: powers of two, BERT's vocab, small odd ones, > 2**16 (the
# multiplier's square wraps in uint32), an empty range (minval returned),
# negative bounds
SPANS = [(0, 128), (0, 30522), (5, 17), (0, 3), (-100, 70000),
         (0, 65537), (0, 2 ** 31 - 1), (7, 7)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", SPANS)
def test_randint_bitwise(seed, lo, hi):
    for shape in [(4, 7), (2, 512)]:
        got = prng.randint(prng.prng_key(seed), int(np.prod(shape)), lo, hi)
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
        assert np.asarray(want).dtype == np.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64)
                                      .ravel())


def test_a_block_of_a_draw_is_those_elements_of_the_whole():
    key, jkey = prng.prng_key(9), jax.random.PRNGKey(9)
    shape, rows = (8, 16), slice(4, 6)
    n, offset = 2 * 16, 4 * 16
    np.testing.assert_array_equal(
        prng.bernoulli(key, 0.15, n, offset).numpy(),
        np.asarray(jax.random.bernoulli(jkey, 0.15, shape))[rows].ravel())
    np.testing.assert_array_equal(
        prng.randint(key, n, 0, 30522, offset).numpy(),
        np.asarray(jax.random.randint(jkey, shape, 0, 30522))[rows].ravel())
    np.testing.assert_array_equal(
        prng.uniform(key, n, offset=offset).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jkey, shape))[rows].ravel()
        .view(np.int32))


# ---------------------------------------------------------------------------
# the task against the JAX task, with a fixed logits function for a model
# ---------------------------------------------------------------------------

TABLE = np.random.RandomState(3).randn(VOCAB, VOCAB).astype(np.float32)


def batch_of(rows, seq=24, seed=0):
    rng = np.random.RandomState(seed)
    w = np.ones(rows, np.float32)
    w[-1] = 0.0                    # a padding row: weighted out
    return {"input_ids": rng.randint(0, VOCAB, (rows, seq)).astype(np.int32),
            "weight": w}


def jax_task(batch, rng):
    """The JAX task's (model inputs, loss, metrics) on ``batch``, its
    model the TABLE lookup."""
    seen = []

    class State:
        batch_stats = {}

        @staticmethod
        def apply_fn(variables, inputs, train, rngs):
            seen.append(np.asarray(inputs))
            return jnp.asarray(TABLE)[inputs]

    loss, (metrics, _) = JaxMLMTask(vocab_size=VOCAB,
                                    mask_token_id=MASK_ID
                                    ).loss_and_metrics(
        State, {}, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        train=True)
    return seen[0], float(loss), {k: float(v) for k, v in metrics.items()}


def port_task(batch, key):
    seen = []

    def model(inputs):
        seen.append(inputs.numpy().copy())
        return torch.from_numpy(TABLE)[inputs]

    loss, metrics, stats = MaskedLMTask(
        vocab_size=VOCAB, mask_token_id=MASK_ID).loss_and_metrics(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, True,
        key=key)
    assert stats == {}
    return seen[0], float(loss), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("seed", [0, 5, 2 ** 20 + 1])
def test_masks_inputs_loss_and_metrics_equal_the_jax_task(seed):
    batch = batch_of(6, seed=seed)
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    j_in, j_loss, j_m = jax_task(batch, rng)
    t_in, t_loss, t_m = port_task(batch, StepKey(
        torch.from_numpy(words(rng))))
    np.testing.assert_array_equal(t_in, j_in)
    assert (t_in != batch["input_ids"]).any()
    # the recipe's three outcomes all occur on 144 positions
    selected = np.asarray(jax.random.bernoulli(
        jax.random.split(rng, 3)[0], 0.15, (6, 24)))
    assert (t_in[selected] == MASK_ID).any()
    assert (t_in[selected] == batch["input_ids"][selected]).any()
    assert t_m["weight"] == j_m["weight"] == float(
        (selected * batch["weight"][:, None]).sum())
    assert t_m["correct"] == j_m["correct"]
    np.testing.assert_allclose(t_m["loss_sum"], j_m["loss_sum"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_a_ranks_rows_of_the_global_draw_are_the_jax_rows(ranks):
    """The replicated path: JAX draws over the global batch; each port
    rank draws its own block of it."""
    rows = 3
    batch = batch_of(rows * ranks, seed=1)
    rng = jax.random.PRNGKey(11)
    j_in, _, _ = jax_task(batch, rng)
    task = MaskedLMTask(vocab_size=VOCAB, mask_token_id=MASK_ID)
    for r in range(ranks):
        mine = torch.from_numpy(batch["input_ids"][r * rows:(r + 1) * rows])
        _, inputs = task.mask(mine.long(), StepKey(
            torch.from_numpy(words(rng)), r * rows))
        np.testing.assert_array_equal(inputs.numpy(),
                                      j_in[r * rows:(r + 1) * rows])
    with pytest.raises(ValueError, match="JAX step key"):
        task.loss_and_metrics(lambda x: x, {
            "input_ids": mine, "weight": torch.ones(rows)}, True)


@pytest.mark.parametrize("replica", [False, True],
                         ids=["replicated", "explicit"])
@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_step_keys_are_the_jax_steps(replica, accum):
    """``fold_in(fold_in(PRNGKey(seed), epoch), step)``, split per
    microbatch (JAX loop.py:588, :781); the explicit paths fold in the
    replica index (:767, :985, :1323)."""
    trainer = Trainer(MaskedLMTask(), TrainConfig(seed=7, grad_accum=accum),
                      device="cpu")
    trainer.epoch, trainer.n_shards, trainer.rank = 2, 4, 3
    got = trainer._step_keys(5, 8, replica)
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 2), 5)
    keys = [rng] if accum == 1 else list(jax.random.split(rng, accum))
    per = 8 // accum
    assert len(got) == accum
    for k, want in zip(got, keys):
        if replica:
            want = jax.random.fold_in(want, 3)
            assert k.first_row == 0
        else:
            assert k.first_row == 3 * per
        np.testing.assert_array_equal(k.key.numpy(), words(want))


def test_eval_draws_from_key_0_every_batch():
    trainer = Trainer(MaskedLMTask(vocab_size=VOCAB, mask_token_id=MASK_ID),
                      TrainConfig(), device="cpu")
    seen = []

    class Model(torch.nn.Module):
        def forward(self, inputs):
            seen.append(inputs.numpy().copy())
            return torch.from_numpy(TABLE)[inputs]

    from distributed_pytorch_training_tpu_torch.training.train_state import (
        TrainState,
    )
    state = TrainState(step=0, model=Model(), optimizer=None, tx=None)
    batch = batch_of(4, seed=2)
    for _ in range(2):
        trainer.eval_step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    j_in, _, _ = jax_task(batch, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(seen[0], j_in)
    np.testing.assert_array_equal(seen[1], seen[0])


# ---------------------------------------------------------------------------
# 2 gloo ranks against the JAX Trainer on a 2-device mesh
# ---------------------------------------------------------------------------

SEQ, GLOBAL_BATCH, STEPS, LR = 16, 8, 3, 0.05
MODEL_KW = dict(vocab_size=VOCAB, hidden_dim=64, depth=2, num_heads=2,
                mlp_dim=128, max_position=SEQ)
# the implicit path (global draws; with accumulation a rank holds one
# block of each interleaved global microbatch), the explicit fp32 reducer
# with accumulation (fold_in(split(key)[i], rank)), and ZeRO-1
# (fold_in(key, rank))
CASES = {"implicit": dict(), "implicit-accum2": dict(grad_accum=2),
         "explicit-fp32-accum2": dict(bucket_cap_mb=0.15, grad_accum=2),
         "zero1": dict(zero1=True)}


def global_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        w = np.ones(GLOBAL_BATCH, np.float32)
        w[-2:] = 0.0
        out.append({"input_ids": rng.randint(
            0, VOCAB, (GLOBAL_BATCH, SEQ)).astype(np.int32), "weight": w})
    return out


def leaves(tree):
    return {path: np.asarray(v) for path, v in iter_flax_leaves(tree)}


@pytest.fixture(scope="module")
def jax_runs(devices):
    mesh2 = build_mesh(MeshSpec(data=2), devices=devices[:2])
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    runs = {}
    for case, cfg in CASES.items():
        jt = JaxTrainer(JaxMLMTask(vocab_size=VOCAB, mask_token_id=MASK_ID),
                        mesh2, JaxTrainConfig(seed=0, print_freq=1000,
                                              **cfg))
        jstate = jt.init_state(jax_get_model("bert_base", **MODEL_KW),
                               np.zeros((1, SEQ), np.int32),
                               jax_make_optimizer("sgd", LR),
                               jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.array,
                                      jax.device_get(jstate.params))
        metrics = []
        for b in global_batches():
            jstate, m = jt._train_step(jstate, shard_batch(b, mesh2),
                                       epoch_key)
            metrics.append({k: float(v) for k, v in m.items()})
        params = (jt._fsdp_unflatten(jstate.params) if jt._fsdp
                  else jstate.params)
        runs[case] = (init, jax.device_get(params), metrics)
    return runs


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tmp_path_factory):
    jobs = {case: ("train", dict(
        mlm=dict(vocab_size=VOCAB, mask_token_id=MASK_ID),
        model_kwargs=MODEL_KW, params=init, lr=LR,
        batches=global_batches(), config=CASES[case]))
        for case, (init, _, _) in jax_runs.items()}
    return run_ranks(tmp_path_factory.mktemp("dp_mlm"), 2, jobs)


@pytest.mark.parametrize("case", list(CASES))
def test_mlm_on_2_ranks_matches_jax_trainer(jax_runs, port_ranks, case):
    params0, jparams, jmetrics = jax_runs[case]
    r0, r1 = (r[case] for r in port_ranks)
    assert r0["step"] == r1["step"] == STEPS
    for ours, theirs, ref in zip(r0["metrics"], r1["metrics"], jmetrics):
        # the masks: the same positions selected as in the JAX step
        assert ours["weight"] == theirs["weight"] == ref["weight"] > 0
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=TRAJ_RTOL)
    a, b = leaves(r0["params"]), leaves(r1["params"])
    for path in a:
        np.testing.assert_array_equal(a[path], b[path])
    ref, start = leaves(jparams), leaves(params0)
    assert a.keys() == ref.keys()
    moved = 0.0
    for path, want in ref.items():
        moved = max(moved, float(np.abs(want - start[path]).max()))
        np.testing.assert_allclose(a[path], want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL
