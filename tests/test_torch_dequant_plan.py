"""K2's launch plan and staged read, on the CPU (no card needed).

The staged variant of ``csrc/dequant_sum_rows.cu`` stages each row of a
column tile in shared memory through a 1-D bulk copy widened out to
16-byte boundaries and clipped to q's storage
(``ops/quantize.py::staged_span``), the few codes the clipped copy cannot
reach read from global memory into the same slot (``ragged_codes``); each
thread then takes its 4 columns of a row from the slot at the row's own
offset as two 4-byte words joined by a funnel shift. This file holds the
plan (``dequant_plan``) and those rules to what the kernel needs:

* every column of every row is summed exactly once, by one thread of one
  block, and each code reaches its slot once, by the copy or as a ragged
  code;
* every copy is 16-byte aligned, a multiple of 16 bytes long, inside q's
  storage, inside its slot of the ring, and within an mbarrier's
  transaction count; the ragged codes are at most 15 at either end, inside
  q;
* over every s mod 16, every view offset mod 16, a storage that starts
  off a 16-byte boundary, n at N_STAGED and N_STAGED + 1, n = 12288, and s
  at 1 and a tile's width +- 1;
* an emulation of the staged read on a byte buffer (the copy and the ragged
  codes into a slot of stale bytes, the words, the funnel shift, the fmaf
  chain through ``fma_f32``) gives the plain version's bits, on codes and
  scales from K1's plain version over numpy-seeded rows.

No tolerance: K2 is bitwise its plain version.
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu_torch.ops.quantize import (
    DEQUANT_THREADS,
    GENERIC_BLOCKS_PER_SM,
    MAX_DEQUANT_ROWS,
    MAX_TILE,
    N_STAGED,
    STAGE_BYTES,
    STAGED_BLOCKS_PER_SM,
    dequant_plan,
    dequant_sum_rows,
    dequant_sum_rows_ref,
    fma_f32,
    quantize_int8_rows_ref,
    ragged_codes,
    staged_span,
)

H100_SMS = 132
RING_STAGES = 4          # the kernel's kStages
GROUPS_PER_THREAD = 4    # the kernel's kGroupsPerThread
MAX_TX_BYTES = (1 << 20) - 1   # an mbarrier phase's transaction count
BASE = 0x7F3A_0000_0000        # a storage address as torch's allocator gives

# the main path's shapes (PERF.md §6): BERT's int8 bucket, ResNet-18's one
# bucket, cap 25's two buckets, the multihop hop-1 chunk, a ZeRO-1 leaf,
# int8_hier's 4-row slices
MAIN_SHAPES = [(2, 109_514_298), (2, 11_181_642), (2, 6_553_600),
               (2, 4_628_042), (2, 5_590_821), (2, 1_179_648), (2, 32),
               (4, 2_795_411), (2, 5_590_821 // 2)]


def widest(n):
    return min(MAX_TILE, STAGE_BYTES // n // 16 * 16)


def tiles_of(plan, s):
    """The column tiles of a staged launch."""
    return -(-s // plan.tile)


def block_tiles(plan, s):
    """{block: [tile indices]} as the persistent grid walks them."""
    tiles = tiles_of(plan, s)
    return {b: list(range(b, tiles, plan.blocks)) for b in range(plan.blocks)}


def thread_columns(w):
    """The columns of a tile of w columns each thread sums, in the
    kernel's order: thread t owns the 4-column groups t + g * 256."""
    cols = []
    for t in range(DEQUANT_THREADS):
        for g in range(GROUPS_PER_THREAD):
            col = 4 * (t + g * DEQUANT_THREADS)
            cols += [c for c in range(col, col + 4) if c < w]
    return cols


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, N_STAGED, N_STAGED + 1,
                               MAX_DEQUANT_ROWS])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 4095, 4096, 4097, 100_003])
def test_plan_variant_and_limits(n, s):
    plan = dequant_plan(n, s, H100_SMS)
    if n > N_STAGED:
        assert not plan.staged and plan.tile == 0
        groups = -(-s // 4)
        assert 1 <= plan.blocks <= GENERIC_BLOCKS_PER_SM * H100_SMS
        # the grid-stride loop covers every group
        assert plan.blocks * DEQUANT_THREADS >= min(
            groups, GENERIC_BLOCKS_PER_SM * H100_SMS * DEQUANT_THREADS)
        return
    assert plan.staged
    assert plan.tile % 16 == 0 and 16 <= plan.tile <= widest(n)
    assert plan.tile <= 4 * GROUPS_PER_THREAD * DEQUANT_THREADS
    tiles = tiles_of(plan, s)
    assert (tiles - 1) * plan.tile < s <= tiles * plan.tile
    assert 1 <= plan.blocks <= min(tiles, STAGED_BLOCKS_PER_SM * H100_SMS)
    # the ring, its barriers and the scales fit the 48 KB of a launch
    assert RING_STAGES * n * (plan.tile + 16) + 8 * RING_STAGES + 4 * n \
        <= 48 * 1024
    if s <= widest(n):
        assert plan.blocks == 1 and tiles == 1
    if tiles <= STAGED_BLOCKS_PER_SM * H100_SMS:
        # one wave: one tile a block
        assert plan.blocks == tiles


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_plan_balances_the_main_path(shape):
    """Past one wave, every block walks as many tiles, to within one."""
    n, s = shape
    plan = dequant_plan(n, s, H100_SMS)
    assert plan.staged and plan.tile <= widest(n)
    tiles = tiles_of(plan, s)
    per_block = [len(ts) for ts in block_tiles(plan, s).values()]
    assert sum(per_block) == tiles and min(per_block) >= 1
    assert max(per_block) - min(per_block) <= 1
    if tiles > STAGED_BLOCKS_PER_SM * H100_SMS:
        assert plan.blocks == STAGED_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("n", [1, 2, 4, N_STAGED])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_plan_covers_every_column_once(n, delta):
    """Tiles, blocks and threads together read each column of each row
    once, across several tiles, a ragged last tile and a ragged group."""
    s = 3 * widest(n) + delta
    plan = dequant_plan(n, s, 2)   # a small card: blocks walk several tiles
    seen = np.zeros(s, np.int64)
    for tiles in block_tiles(plan, s).values():
        for t in tiles:
            c0 = t * plan.tile
            w = min(plan.tile, s - c0)
            cols = np.array(thread_columns(w))
            np.add.at(seen, c0 + cols, 1)
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------


def spans_of(n, s, lo, off, hi):
    """(tile c0, w, row, p, span) of every row of every tile of q at
    storage offset ``off`` of a storage [lo, hi)."""
    plan = dequant_plan(n, s, H100_SMS)
    q = lo + off
    for t in range(tiles_of(plan, s)):
        c0 = t * plan.tile
        w = min(plan.tile, s - c0)
        for i in range(n):
            p = q + i * s + c0
            yield plan, c0, w, i, p, staged_span(p, w, lo, hi)


@pytest.mark.parametrize("lo_skew", [0, 3], ids=["storage16", "storage+3"])
@pytest.mark.parametrize("n", [1, 2, 3, N_STAGED])
@pytest.mark.parametrize("smod", range(16))
def test_spans_aligned_inside_storage_and_slot(smod, n, lo_skew):
    s = 2 * widest(n) + 16 * 3 + smod
    for off in range(16):
        lo = BASE + lo_skew
        hi = lo + off + n * s          # the storage ends with the tensor
        stage_bytes = {}
        for plan, c0, w, i, p, (a, c_lo, c_hi) in spans_of(n, s, lo, off, hi):
            assert a % 16 == 0 and a <= p < a + 16
            if c_lo < c_hi:
                assert c_lo % 16 == 0 and (c_hi - c_lo) % 16 == 0
                assert lo <= c_lo and c_hi <= hi
                # inside the row's slot of tile + 16 bytes
                assert 0 <= c_lo - a and c_hi - a <= plan.tile + 16
                stage_bytes[c0] = stage_bytes.get(c0, 0) + c_hi - c_lo
            # the copy and the ragged codes cover the row's codes once
            head, tail = ragged_codes(p, w, (a, c_lo, c_hi))
            assert len(head) <= 15 and len(tail) <= 15
            copied = range(max(c_lo, p), min(c_hi, p + w))
            assert len(head) + len(copied) + len(tail) == w
            if copied:
                assert head.stop <= copied.start
                assert copied.stop <= tail.start
            for part in (head, tail):
                if part:
                    assert lo + off <= part.start and \
                        part.stop <= lo + off + n * s
        assert max(stage_bytes.values()) <= MAX_TX_BYTES


def test_only_the_storage_ends_leave_the_copy():
    """Inside the storage a row's copy reaches every code: only a row tile
    within 16 bytes of the storage's ends has ragged codes."""
    n, s = 2, 10_000 + 5
    for off in range(16):
        lo = BASE + 3
        hi = lo + off + n * s
        for _, c0, w, i, p, span in spans_of(n, s, lo, off, hi):
            head, tail = ragged_codes(p, w, span)
            if p - lo >= 16 and hi - (p + w) >= 16:
                assert not head and not tail
                assert span[1] == span[0] and span[2] >= p + w


# ---------------------------------------------------------------------------
# the staged read, emulated on a byte buffer
# ---------------------------------------------------------------------------


def wire_codes(n, s, seed):
    """Codes and scales as the wire makes them: K1's plain version on
    numpy-seeded rows of spread magnitudes (an all-zero row among 3+)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, s) * rng.uniform(0.01, 10.0, (n, 1))).astype(np.float32)
    if n > 2:
        x[1] = 0.0
    return quantize_int8_rows_ref(torch.from_numpy(x))


def emulate_staged(storage, lo, off, n, s, scales):
    """The staged kernel on a byte buffer: ``storage`` holds q's storage
    [lo, lo + len) with q at offset ``off``; returns the (s,) sums."""
    hi = lo + storage.size
    out = torch.empty(s, dtype=torch.float32)
    plan = dequant_plan(n, s, H100_SMS)
    for t in range(tiles_of(plan, s)):
        c0 = t * plan.tile
        w = min(plan.tile, s - c0)
        acc = torch.zeros(w, dtype=torch.float32)
        cols = np.arange(w)
        for i in range(n):
            p = lo + off + i * s + c0
            a, c_lo, c_hi = staged_span(p, w, lo, hi)
            # the row's slot: stale bytes, the copy at c_lo - a, then the
            # ragged codes from global memory
            slot = np.full(plan.tile + 16, 0xA5, np.uint8)
            if c_lo < c_hi:
                slot[c_lo - a:c_hi - a] = storage[c_lo - lo:c_hi - lo]
            for part in ragged_codes(p, w, (a, c_lo, c_hi)):
                for at in part:
                    slot[at - a] = storage[at - lo]
            words = slot.view("<u4").astype(np.uint64)
            o = p & 15
            word = (o >> 2) + cols // 4     # each group's first word
            joined = words[word] | (words[word + 1] << np.uint64(32))
            shifted = joined >> np.uint64(8 * (o & 3))
            codes = ((shifted >> np.uint64(8) * (cols % 4).astype(
                np.uint64)) & np.uint64(0xFF)).astype(np.uint8).view(np.int8)
            acc = fma_f32(torch.from_numpy(codes.copy()).float(),
                          scales[i], acc)
        out[c0:c0 + w] = acc
    return out


@pytest.mark.parametrize("lo_skew", [0, 3], ids=["storage16", "storage+3"])
@pytest.mark.parametrize("shape", [(2, 4096 * 2 + 7), (3, 2720 + 1),
                                   (N_STAGED, 1024 - 1), (1, 17), (2, 1),
                                   (4, 2048 * 2 + 10)], ids=str)
def test_staged_emulation_bitwise_equals_plain(shape, lo_skew):
    n, s = shape
    q, scales = wire_codes(n, s, seed=n * 7 + s)
    want = dequant_sum_rows_ref(q, scales)
    rng = np.random.RandomState(s)
    for off in (0, 1, 5, 15):
        storage = rng.randint(0, 256, off + n * s, dtype=np.uint8)
        storage[off:] = q.numpy().view(np.uint8).reshape(-1)
        got = emulate_staged(storage, BASE + lo_skew, off, n, s, scales)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------


def test_wrapper_refuses_a_device_without_a_kernel():
    q = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    s = torch.ones(2, device="meta")
    before = dequant_sum_rows.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dequant_sum_rows(q, s)
    with pytest.raises(ValueError, match="codes on meta, scales on cpu"):
        dequant_sum_rows(q, torch.ones(2))
    with pytest.raises(ValueError, match="at most 12288 rows"):
        dequant_sum_rows(torch.zeros((12289, 1), dtype=torch.int8),
                         torch.ones(12289))
    assert dequant_sum_rows.launches == before


def test_wrapper_takes_a_cpu_view_at_any_offset_through_the_plain_version():
    q, scales = wire_codes(2, 1025, seed=3)
    flat = torch.cat([torch.zeros(16, dtype=torch.int8), q.reshape(-1)])
    before = dequant_sum_rows.launches
    for off in range(16):
        view = flat[off:off + 2 * 1000].reshape(2, 1000)
        got = dequant_sum_rows(view, scales)
        want = dequant_sum_rows_ref(view, scales)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
    assert dequant_sum_rows.launches == before
