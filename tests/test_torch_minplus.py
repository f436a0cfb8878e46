"""The port's min-plus op against grl_tpu's Pallas kernel (interpret mode)."""

import numpy as np
import pytest
import torch

from grl_tpu.ops import minplus_matmul
from grl_tpu_torch.ops import minplus, minplus_plain
from grl_tpu_torch.ops.minplus import (MAX_SPLITS, MIN_CHUNKS_PER_PART, aligned, padded_empty,
                                       row_strides, schedule)

CASES = {
    # the dense and the ragged (non-tile-multiple m, n, k) cases of test_ops.py
    "dense": lambda rng: (np.abs(rng.randn(37, 300)), np.abs(rng.randn(150, 300))),
    "ragged": lambda rng: (rng.rand(5, 17), rng.rand(9, 17)),
}


def _inputs(case):
    a, b = CASES[case](np.random.RandomState(0))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    a, b = _inputs(case)
    want = np.asarray(minplus_matmul(a, b, interpret=True))
    got = minplus_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk_elems", [1, 300, 5000])
def test_plain_chunking_is_exact(chunk_elems):
    a, b = (torch.from_numpy(x) for x in _inputs("dense"))
    whole = torch.minimum(a[:, None, :], b[None, :, :]).sum(-1)
    torch.testing.assert_close(minplus_plain(a, b, chunk_elems=chunk_elems), whole, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    a, b = (torch.from_numpy(x) for x in _inputs("ragged"))
    before = minplus.launches
    out = minplus(a, b)
    assert minplus.launches == before
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=0)


def test_wrapper_rejects_bad_operands():
    a = torch.rand(4, 8)
    with pytest.raises(ValueError):
        minplus(a, torch.rand(5, 7))
    with pytest.raises(TypeError):
        minplus(a.double(), torch.rand(5, 8).double())
    with pytest.raises(ValueError):
        minplus(a[0], torch.rand(5, 8))


# the kernel's tile (BM, BN, BK) and an H100's block slots (132 SMs x 1)
TILE, SLOTS = (128, 256, 32), 132


def test_schedule_at_mars():
    # 16 x 52 = 832 tiles: 6 whole rounds of 132, then 40 tiles split in 3
    assert schedule(1980, 13290, 13290, TILE, SLOTS) == (132, 792, 3)


@pytest.mark.parametrize("shape, want", [
    ((5, 9, 17), (1, 0, 1)),              # one tile, one chunk: nothing to split
    ((129, 257, 1000), (32, 0, 8)),       # 4 tiles, 32 chunks: split in MAX_SPLITS
    ((129, 257, 0), (4, 0, 1)),           # k = 0: no chunk to split
    ((128 * 12, 256 * 11, 64), (132, 132, 1)),  # whole rounds only
])
def test_schedule_cases(shape, want):
    assert schedule(*shape, TILE, SLOTS) == want


def _units(m, n, k, tile, slots):
    """A model of the kernel's walk, written after ``minplus_kernel``'s
    decode of a unit into (tile, first chunk, end chunk): every block's
    units for ``schedule``'s split. The walk itself runs only on the card
    (tests/test_torch_cuda.py holds it to the plain version)."""
    grid, dp_tiles, splits = schedule(m, n, k, tile, slots)
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    chunks = -(-k // tile[2])
    units = dp_tiles + (tiles - dp_tiles) * splits
    walk = []
    for block in range(grid):
        mine = []
        for u in range(block, units, grid):
            if u < dp_tiles:
                mine.append((u, 0, chunks))
            else:
                idx = u - dp_tiles
                part = idx % splits
                mine.append((dp_tiles + idx // splits, chunks * part // splits,
                             chunks * (part + 1) // splits))
        walk.append(mine)
    return grid, splits, walk


@pytest.mark.parametrize("slots", [1, 7, 132, 264])
@pytest.mark.parametrize("shape", [(1980, 13290, 13290), (129, 257, 1000), (3000, 700, 40), (5, 9, 17)])
def test_schedule_covers_every_tile_chunk_once_and_balances(shape, slots):
    """``schedule``'s split, walked as the kernel walks it (``_units``)."""
    m, n, k = shape
    grid, splits, walk = _units(m, n, k, TILE, slots)
    tiles = -(-m // TILE[0]) * -(-n // TILE[1])
    chunks = -(-k // TILE[2])
    assert 1 <= grid <= slots and 1 <= splits <= MAX_SPLITS
    covered = {}
    for mine in walk:
        for tile, c0, c1 in mine:
            assert 0 <= c0 < c1 <= chunks or chunks == 0
            covered.setdefault(tile, []).extend(range(c0, c1))
    assert sorted(covered) == list(range(tiles))
    assert all(sorted(c) == list(range(chunks)) for c in covered.values())
    # balance: no block does more than one round (in chunks) beyond the least loaded
    load = [sum(c1 - c0 for _, c0, c1 in mine) for mine in walk]
    assert max(load) - min(load) <= chunks


@pytest.mark.parametrize("slots", [7, 132, 264])
@pytest.mark.parametrize("shape", [(1980, 13290, 13290), (129, 257, 1000), (3000, 700, 40),
                                   (128 * 12, 256 * 11, 64)])
def test_schedule_splits_only_the_last_round_and_fills_it(shape, slots):
    m, n, k = shape
    grid, dp_tiles, splits = schedule(m, n, k, TILE, slots)
    tiles = -(-m // TILE[0]) * -(-n // TILE[1])
    chunks = -(-k // TILE[2])
    rounds, tail = divmod(tiles, slots)
    assert dp_tiles == rounds * slots and grid == (slots if rounds else tail * splits)
    if not tail:
        assert splits == 1
        return
    # the split round fits in one round of slots, each part keeps its pipeline busy,
    # and one more part per tile would overflow the round or one of those limits
    assert tail * splits <= slots and 1 <= splits <= MAX_SPLITS
    assert splits == 1 or chunks // splits >= MIN_CHUNKS_PER_PART
    assert (tail * (splits + 1) > slots or splits == MAX_SPLITS
            or chunks // (splits + 1) < MIN_CHUNKS_PER_PART)


def test_row_strides_take_row_slices_and_refuse_column_strides():
    wide = torch.rand(10, 23)
    assert row_strides(wide[:, 2:20], wide[3:, :18]) == (23, 23)
    assert row_strides(torch.rand(4, 8), torch.rand(6, 8)) == (8, 8)
    with pytest.raises(ValueError):
        row_strides(torch.rand(8, 4).T, torch.rand(6, 8))
    with pytest.raises(ValueError):
        row_strides(torch.rand(4, 8), wide[:, ::2][:, :8])


def test_wrapper_on_cpu_takes_strided_views():
    wide = torch.rand(30, 41)
    a, b = wide[:7, 1:40], wide[5:, :39]
    torch.testing.assert_close(minplus(a, b), minplus_plain(a.contiguous(), b.contiguous()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 4, 13290])
def test_padded_empty_rows_are_16_byte_aligned(k):
    x = padded_empty(3, k)
    assert x.shape == (3, k) and x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.stride(0) >= k
    assert x.data_ptr() % 16 == 0


def test_aligned_copies_only_what_the_kernel_cannot_read():
    dense = torch.rand(5, 8)  # row stride 8: readable in place
    rows, empty = dense[1:], dense[:, 1:1]  # 32 bytes in; k = 0 reads nothing
    assert aligned(dense) is dense and aligned(rows) is rows and aligned(empty) is empty
    for x in (torch.rand(5, 7), dense[:, 1:], torch.rand(1, 8).expand(5, 8)):
        # stride 7, a start 4 bytes in, overlapping rows
        y = aligned(x)
        assert y is not x and y.stride(0) % 4 == 0 and y.data_ptr() % 16 == 0
        torch.testing.assert_close(y, x, rtol=0, atol=0)
