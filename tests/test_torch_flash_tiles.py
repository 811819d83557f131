"""The bf16 flash kernel's tile plan (`repro_torch.kernels.flash_attention`
`tile_plan` / `tile_work`, the Python mirror of flash_bf16's tiling in
csrc/flash_attention.cu) against a brute-force count of the causal/window
band.

What the card cannot show here: that every 128-row tile holds whole
positions of one kv head's q heads, that the KV tiles a block reads cover
every unmasked (q, k) pair of its rows and no tile more, that the blocks
cover every (batch, head, position) once, that the launch order runs the
heaviest tiles first, and that the tile fits the card's shared memory. The
card tests (tests/test_torch_cuda.py) hold the library's tile against this
mirror.
"""

import itertools

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa


def unmasked_pairs(sq, sk, causal, window):
    """(q, k) pairs the causal/window band leaves unmasked (last q on last k)."""
    p = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def band_mask(sq, sk, causal, window):
    qi = np.arange(sq)[:, None] + (sk - sq)
    ki = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    return mask


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 7, 8, 16, 42, 64, 100, 128, 129, 200, 256, 300])
def test_tile_holds_whole_positions(g):
    plan = fa.tile_plan(g, 1000, 80)
    assert plan.heads * plan.positions <= fa.ROWS
    assert plan.heads * plan.head_chunks >= g > plan.heads * (plan.head_chunks - 1)
    assert plan.head_chunks == -(-g // fa.ROWS)  # as few chunks as 128 rows allow
    assert plan.positions == fa.ROWS // plan.heads and plan.q_tiles == -(-1000 // plan.positions)
    if g <= fa.ROWS:  # one chunk: every row of a position is one of the G heads
        assert plan.heads == g


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_tile_fits_shared_memory(d):
    """Q tile + ring of K and V tiles + alignment, within the 227 KB a block
    may use (static shared memory holds only the mbarriers)."""
    assert fa.smem_bytes(d) + 64 <= fa.SMEM_LIMIT
    assert fa.ring_depth(d) >= 2 and fa.kv_tile(d) % 64 == 0
    # every box of the Q, K and V tiles starts on a 1024-byte swizzle atom
    assert fa.ROWS * d * 2 % 1024 == 0 and fa.kv_tile(d) * d * 2 % 1024 == 0


CASES = [
    # batch, heads, kv heads, sq, sk, d, causal, window
    (1, 32, 8, 4608, 4608, 80, True, 4096),  # h2o-danube's longest prefill
    (1, 32, 8, 777, 777, 80, True, 4096),  # ragged, window wider than Sq
    (1, 16, 16, 300, 300, 256, True, 0),  # gemma-7b heads
    (2, 12, 4, 333, 333, 80, True, 100),  # G = 3, ragged, window
    (1, 6, 2, 77, 700, 80, True, 5),  # Sq < Sk, window narrower than a tile
    (1, 4, 2, 200, 150, 64, True, 0),  # Sq > Sk: the first rows see no key
    (1, 12, 4, 70, 70, 32, False, 0),  # bidirectional
    (1, 8, 2, 300, 300, 96, False, 40),  # window without the causal mask
    (2, 8, 1, 150, 150, 128, True, 0),  # MQA (G = 8)
    (1, 4, 4, 1, 129, 80, True, 0),  # one query row
    (1, 130, 1, 50, 50, 64, True, 0),  # G = 130: two head chunks of 65
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_tile_work_covers_the_band(case):
    b, h, kvh, sq, sk, d, causal, window = case
    g = h // kvh
    plan = fa.tile_plan(g, sq, d)
    bk = plan.kv_tile
    mask = band_mask(sq, sk, causal, window)
    seen, covered = set(), 0
    for w in fa.tile_work(plan, b, kvh, sq, sk, causal, window):
        key = (w.batch, w.kv_head, w.h0, w.q0)
        assert key not in seen
        seen.add(key)
        assert w.q0 % plan.positions == 0 and 0 < w.q1 - w.q0 <= plan.positions
        rows = mask[w.q0:w.q1]
        keys = np.flatnonzero(rows.any(axis=0))
        if keys.size == 0:
            assert w.kv1 == w.kv0  # nothing to read: the rows come back 0
            continue
        # every unmasked key of the tile's rows lies in the KV tiles it reads,
        # and its first and last KV tiles each hold one
        assert w.kv0 * bk <= keys[0] < (w.kv0 + 1) * bk
        assert (w.kv1 - 1) * bk <= keys[-1] < w.kv1 * bk
        covered += int(rows.sum()) * min(plan.heads, g - w.h0)
    # the blocks cover every (batch, head, position) once
    assert len(seen) == b * kvh * plan.head_chunks * plan.q_tiles
    assert covered == b * h * unmasked_pairs(sq, sk, causal, window)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_launch_order_is_heaviest_first(case):
    """Under a causal mask a later q tile's band ends later, so the blocks
    run the q tiles backwards; without it a window starts an earlier tile's
    band earlier, so they run forwards. Within one q tile every (batch, kv
    head, chunk) group is launched before the next q tile."""
    b, h, kvh, sq, sk, d, causal, window = case
    plan = fa.tile_plan(h // kvh, sq, d)
    work = list(fa.tile_work(plan, b, kvh, sq, sk, causal, window))
    groups = b * kvh * plan.head_chunks
    for first, second in zip(work, work[groups:]):
        assert (second.q0 < first.q0) if causal else (second.q0 > first.q0)
    for a_, b_ in itertools.pairwise(work):
        if causal:
            assert b_.q1 <= a_.q1 and b_.kv1 <= a_.kv1
        else:
            assert b_.kv0 >= a_.kv0
    counts = [w.kv1 - w.kv0 for w in work]
    assert counts[0] >= max(counts) - 1  # within one tile of the heaviest


def test_prefill_plan_at_h2o_danube():
    """The launch chip_smoke.py times: G = 4, 32 positions a tile, 1152
    blocks, 1-33 KV tiles of 128 keys, the heaviest first; 3.1 % more FLOPs
    than the band needs (the masked parts of edge tiles; no padded head
    dims)."""
    plan = fa.tile_plan(4, 4608, 80)
    assert (plan.heads, plan.positions, plan.q_tiles, plan.kv_tile, plan.ring) == (4, 32, 144, 128, 3)
    work = list(fa.tile_work(plan, 1, 8, 4608, 4608, True, 4096))
    counts = [w.kv1 - w.kv0 for w in work]
    assert len(work) == 1152 and (min(counts), max(counts)) == (1, 33) and counts[0] == 33
    computed = 4 * 80 * fa.ROWS * plan.kv_tile * sum(counts)
    needed = 4 * 32 * 80 * unmasked_pairs(4608, 4608, True, 4096)
    assert 1.0 < computed / needed < 1.035
