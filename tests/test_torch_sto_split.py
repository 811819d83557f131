"""The RK4 kernels' work splits on the CPU: the cooperative kernel's
(kernels/sto_step.py coop_split) and field_tiled's (field_split: the same
cluster sizes and slices, one cluster per output tile), with
coop_block_work, which mirrors csrc/sto_rk4.cu.

Every (row, lane) output of a stage has exactly one block that reduces it
and runs its epilogue; every contraction index of every output is summed by
exactly one block of the output tile's cluster; and the split does not
change with E, so a lane's sums are the same however many lanes share the
launch. The co-resident clusters are modelled as floor(SMs / C) (one block
per SM); on the card they come from cudaOccupancyMaxActiveClusters.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import sto_step

W_DTYPES = (torch.float32, torch.bfloat16)
# the card tests' shapes, and the serving shape on a 132- and a 114-SM card
CASES = [(n, e, 132) for n in (64, 320, 2560, 4096) for e in (64, 320)] + [
    (2560, 256, 132),
    (2560, 256, 114),
]


def _split(n, e, sms, w_dtype):
    return sto_step.coop_split(n, e, lambda c: sms // c, sto_step.COOP_ROWS[w_dtype])


def _work(split, n, e):
    return [list(sto_step.coop_block_work(split, n, e, b)) for b in range(split.blocks)]


def _field_split(n, e, sms, w_dtype):
    return sto_step.field_split(n, e, lambda c: sms // c, sto_step.COOP_ROWS[w_dtype])


def _assert_one_owner(split, n, e):
    owners = np.zeros((n, e), dtype=np.int64)
    for items in _work(split, n, e):
        for w in items:
            assert w.rows[0] <= w.reduce_rows[0] <= w.reduce_rows[1] <= w.rows[1] <= n
            owners[slice(*w.reduce_rows), slice(*w.lanes)] += 1
    assert (owners == 1).all()


def _assert_summed_once(split, n, e):
    # summed[row, lane, k] would be N^2 E; every output of a tile shares its
    # blocks' k ranges, so count per (tile rows, lanes) and k
    summed = {}
    for items in _work(split, n, e):
        for w in items:
            key = (w.rows, w.lanes)
            summed.setdefault(key, np.zeros(n, dtype=np.int64))[slice(*w.k)] += 1
    tiles = {(w.rows, w.lanes) for items in _work(split, n, e) for w in items}
    assert len(summed) == len(tiles) == split.items
    for count in summed.values():
        assert (count == 1).all()
    covered = np.zeros((n, e), dtype=np.int64)
    for rows, lanes in tiles:
        covered[slice(*rows), slice(*lanes)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n,e,sms", CASES)
def test_every_output_has_one_owner(n, e, sms, w_dtype):
    _assert_one_owner(_split(n, e, sms, w_dtype), n, e)


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n,e,sms", CASES)
def test_every_contraction_index_is_summed_once(n, e, sms, w_dtype):
    _assert_summed_once(_split(n, e, sms, w_dtype), n, e)


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n,e,sms", CASES)
def test_field_split_owns_and_sums_once(n, e, sms, w_dtype):
    """field_tiled: one cluster per output tile, every (row, lane) reduced
    by one block and every (row, lane, k) summed by one block."""
    split = _field_split(n, e, sms, w_dtype)
    assert split.clusters == split.items and split.blocks == split.cluster * split.items
    assert split.cluster == _split(n, e, sms, w_dtype).cluster  # the same C as the coop split
    assert split.waves == -(-split.items // (sms // split.cluster))
    _assert_one_owner(split, n, e)
    _assert_summed_once(split, n, e)


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n,e,sms", CASES)
def test_launch_fits_the_card(n, e, sms, w_dtype):
    split = _split(n, e, sms, w_dtype)
    assert 1 <= split.cluster <= sto_step.MAX_CLUSTER
    assert split.clusters <= sms // split.cluster  # co-resident, as a cooperative launch needs
    assert split.blocks <= sms
    assert split.cluster <= n // sto_step.SLICE  # every block has a slice to sum
    assert split.items == -(-n // split.rows) * -(-e // sto_step.COOP_LANES)


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n", [64, 320, 2560, 4096])
def test_split_does_not_vary_with_e(n, w_dtype):
    """Cluster size, tile height and each rank's contraction slice follow N
    alone; a wider E only adds lane tiles."""
    base = _split(n, 64, 132, w_dtype)
    k_of_rank = [next(sto_step.coop_block_work(base, n, 64, r)).k for r in range(base.cluster)]
    for e in (128, 256, 320, 1024):
        split = _split(n, e, 132, w_dtype)
        assert (split.cluster, split.rows) == (base.cluster, base.rows)
        for b in range(split.blocks):
            for w in sto_step.coop_block_work(split, n, e, b):
                assert w.k == k_of_rank[b % split.cluster]


@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n", [64, 320, 2560, 4096, 10048])
def test_field_split_does_not_vary_with_e(n, w_dtype):
    """field_tiled's cluster size, tile height and each rank's slice follow
    N alone; a wider E only adds tiles (and clusters)."""
    base = _field_split(n, 64, 132, w_dtype)
    k_of_rank = [next(sto_step.coop_block_work(base, n, 64, r)).k for r in range(base.cluster)]
    for e in (128, 256, 320, 1024):
        split = _field_split(n, e, 132, w_dtype)
        assert (split.cluster, split.rows) == (base.cluster, base.rows)
        for b in range(split.blocks):
            for w in sto_step.coop_block_work(split, n, e, b):
                assert w.k == k_of_rank[b % split.cluster]


def test_serving_shape_split_on_h100():
    """N = 2560, E = 256 with the co-resident clusters an H100 SXM reported
    for this kernel (132, 66, 39, 30, 22, 17, 15, 15 for C = 1..8): bf16
    takes its 128-row tiles in clusters of 5, one round; f32 its 64-row
    tiles in clusters of 8, three rounds (one fifth of the contraction per
    block and two rounds cost more)."""
    resident = dict(enumerate((132, 66, 39, 30, 22, 17, 15, 15), start=1))
    f32 = sto_step.coop_split(2560, 256, resident.get, sto_step.COOP_ROWS[torch.float32])
    bf16 = sto_step.coop_split(2560, 256, resident.get, sto_step.COOP_ROWS[torch.bfloat16])
    assert (f32.cluster, f32.clusters, f32.blocks, f32.rounds) == (8, 15, 120, 3)
    assert (bf16.cluster, bf16.clusters, bf16.blocks, bf16.rounds) == (5, 20, 100, 1)


def test_unpadded_shapes_are_refused():
    with pytest.raises(ValueError, match="padded"):
        sto_step.coop_split(2500, 256, lambda c: 132 // c)


def test_field_split_on_h100():
    """field_tiled with the co-resident clusters an H100 SXM reported for its
    kernel (one block an SM, as for rk4_coop_kernel: 132, 66, 39, 30, 22, 17,
    15, 15 for C = 1..8): at N = 2560 f32 takes 40 tiles in clusters of 8 (3
    waves), bf16 20 tiles in clusters of 5 (1 wave); at N = 10048 f32 157
    tiles in clusters of 8 (11 waves), bf16 79 in clusters of 4 (3 waves).
    Each is the fastest C that tools/field_split_sweep.py timed there."""
    resident = dict(enumerate((132, 66, 39, 30, 22, 17, 15, 15), start=1))
    got = {
        (n, w_dtype): sto_step.field_split(n, 256, resident.get, sto_step.COOP_ROWS[w_dtype])
        for n in (2560, 10048)
        for w_dtype in W_DTYPES
    }
    want = {
        (2560, torch.float32): (8, 40, 3),
        (2560, torch.bfloat16): (5, 20, 1),
        (10048, torch.float32): (8, 157, 11),
        (10048, torch.bfloat16): (4, 79, 3),
    }
    assert {k: (s.cluster, s.items, s.waves) for k, s in got.items()} == want


@pytest.mark.parametrize(
    "n,w_dtype,costs",
    [
        (2560, torch.float32, (161, 81, 114, 82, 66, 87, 75, 63)),
        (2560, torch.bfloat16, (321, 161, 113, 81, 65, 114, 98, 82)),
        (10048, torch.float32, (1258, 951, 1065, 966, 1032, 1090, 1023, 891)),
        (10048, torch.bfloat16, (1257, 1266, 1275, 963, 1028, 1085, 1110, 966)),
    ],
)
def test_split_cost_is_what_the_split_minimises(n, w_dtype, costs):
    """split_cost at the H100's co-resident clusters (132, 66, 39, 30, 22,
    17, 15, 15 for C = 1..8) gives the per-C costs PERF.md works through, and
    field_split and coop_split pick the C of the least."""
    resident = dict(enumerate((132, 66, 39, 30, 22, 17, 15, 15), start=1))
    rows = sto_step.COOP_ROWS[w_dtype]
    got = tuple(sto_step.split_cost(n, rows, c, resident[c]) for c in range(1, 9))
    assert got == costs
    best = 1 + costs.index(min(costs))
    assert sto_step.field_split(n, 256, resident.get, rows).cluster == best
    assert sto_step.coop_split(n, 256, resident.get, rows).cluster == best
