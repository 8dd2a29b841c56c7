"""The raycast kernels' two inter-CTA protocols (`csrc/raycast.cu`),
emulated on the CPU over the wrapper's own scratch
(`ops/raycast_kernel.Scratch`), CTA by CTA in random orders:

- the merged scan's decoupled look-back: each CTA draws its tile from the
  ticket, publishes its count of flagged rays, looks back over the tiles
  before it 32 at a time until an inclusive count, publishes its own and
  ranks its rays; the last CTA to end its look-back zeroes the status
  words and the counters, so the next call finds its scratch clean,
  however the tile count changes;
- R1's ticket: every CTA splats, then draws a ticket; the last one pools
  the encoded grid and leaves it and the ticket zero.

The kernels themselves run only on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`); this holds the protocols' logic at small sizes."""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.ops import raycast_kernel as rk

TILE = rk.SCAN_TILE
AGG, INCL = 1, 2
MASK32 = 0xFFFFFFFF


def _word(flag, count):
    return (flag << 32) | count


def _cta_scan(need, st, ctl, tiles, budget, out):
    """One CTA of the merged scan, as a generator that yields where the
    kernel would wait or another CTA may run in between."""
    tile = int(ctl[0])
    ctl[0] += 1
    yield
    flags = need[tile * TILE:(tile + 1) * TILE]
    count = int(flags.sum())
    st[tile] = np.uint64(_word(INCL if tile == 0 else AGG, count))
    yield
    before = 0
    if tile > 0:
        end = tile - 1
        while True:
            seen = []
            for lane in range(32):
                t = end - lane
                if t < 0:
                    seen.append((INCL, 0))
                    continue
                while True:
                    w = int(st[t])
                    flag = (w >> 32) & 3
                    if flag:
                        break
                    yield                       # spin
                seen.append((flag, w & MASK32))
            incl = [f == INCL for f, _ in seen]
            stop = incl.index(True) if any(incl) else 31
            before += sum(v for _, v in seen[:stop + 1])
            if any(incl):
                break
            end -= 32
        st[tile] = np.uint64(_word(INCL, before + count))
    yield
    # the last look-back to end cleans the scratch for the next call
    last = int(ctl[1]) == tiles - 1
    ctl[1] += 1
    if last:
        st[:tiles] = 0
        ctl[:] = 0
    k = min(max(budget - before, 0), count)
    rank = np.cumsum(flags) - 1
    for i in np.flatnonzero(flags):
        out["rank"][tile * TILE + i] = before + rank[i]
        out["redo"][tile * TILE + i] = rank[i] < k
    out["tiles"].append(tile)


def _run(ctas, rng):
    """Step the live CTAs in a random order until every one has ended."""
    live = list(ctas)
    while live:
        g = live[rng.integers(len(live))]
        try:
            next(g)
        except StopIteration:
            live.remove(g)


def _scan_call(sc, need, budget, rng):
    """One launch over ``need`` (the flagged rays, raster order): the
    wrapper's scratch, the CTAs started (tickets drawn) in a random order
    and stepped in another."""
    tiles = -(-need.size // TILE)
    st = sc.scan(tiles).numpy().view(np.uint64)
    ctl = sc.ctl.numpy().view(np.uint32)
    assert not st.any() and not ctl.any()
    out = dict(rank=np.full(need.size, -1), redo=np.zeros(need.size, bool),
               tiles=[])
    padded = np.zeros(tiles * TILE, bool)
    padded[:need.size] = need
    # a CTA draws its ticket when it first runs; they start in any order
    ctas = [_cta_scan(padded, st, ctl, tiles, budget, out)
            for _ in range(tiles)]
    _run(ctas, rng)
    assert sorted(out["tiles"]) == list(range(tiles))
    assert not st.any() and not ctl.any()
    return out


def _check(out, need, budget):
    flagged = np.flatnonzero(need)
    np.testing.assert_array_equal(out["rank"][flagged],
                                  np.arange(flagged.size))
    assert (out["rank"][~need] == -1).all()
    want = torch.nonzero(torch.from_numpy(need))[:, 0][:budget].numpy()
    np.testing.assert_array_equal(np.flatnonzero(out["redo"]), want)


@pytest.mark.parametrize("tiles", [(75, 300, 3), (300, 75, 300),
                                   (1, 33, 2)])
def test_look_back_ranks_in_raster_order_across_calls(tiles):
    """Calls over the given tile counts (75 the half-resolution headline,
    300 the full-resolution scan, 3, 2 and 1 short strips, 33 one more
    than a look-back round), each with a ragged last tile where it has
    one, twice over, on one scratch: each flagged ray's rank is its place
    in ``torch.nonzero(need2)``, and the rays re-scanned are exactly
    ``nonzero(need2)[:budget]`` at budget 0, at a budget that cuts a
    tile in the middle and at one above the count; each call leaves the
    scratch zero."""
    rng = np.random.default_rng(sum(tiles))
    sc = rk.Scratch(torch.device("cpu"))
    for n in tiles * 2:
        rays = n * TILE - (17 if n % 2 else 0)
        need = rng.random(rays) < rng.uniform(0.05, 0.5)
        flagged = np.flatnonzero(need) // TILE
        mid = flagged.size // 2
        while flagged[mid - 1] != flagged[mid]:
            mid += 1
        for budget in (0, mid, flagged.size + 100):
            _check(_scan_call(sc, need, budget, rng), need, budget)


def _encode_min(z):
    return 0x7F800000 - int(np.float32(z).view(np.uint32))


def _cta_splat(contrib, enc, cells, n_ctas, out):
    """One CTA of R1: its slots' atomics (cell, start, far depth), its
    ticket after them, and the pools' read and clean-up if it is last."""
    for cell, lo, hi in contrib:
        enc[cell] = max(int(enc[cell]), _encode_min(lo))
        enc[cells + cell] = max(int(enc[cells + cell]),
                                int(np.float32(hi).view(np.uint32)))
        yield
    last = int(enc[2 * cells]) == n_ctas - 1
    enc[2 * cells] += 1
    yield
    if not last:
        return
    e_min = enc[:cells].astype(np.int64)
    e_max = enc[cells:2 * cells]
    out["tmin"] = np.array(0x7F800000 - e_min, np.uint32).view(np.float32)
    out["tmax"] = np.where(e_max == 0, -np.inf,
                           e_max.view(np.float32)).astype(np.float32)
    enc[:2 * cells + 1] = 0


@pytest.mark.parametrize("cells", [1200, 4800])
def test_splat_ticket_pools_once_and_leaves_the_scratch_zero(cells):
    """Two calls on one scratch (its grid grown between the sizes): the
    CTAs splat in a random interleaving, exactly the last to draw a ticket
    pools, and its grids are the scatter min and max of every slot's
    depths (inf and -inf where none falls); the encoded grid and the
    ticket are zero after each call."""
    rng = np.random.default_rng(cells)
    sc = rk.Scratch(torch.device("cpu"))
    for call in range(2):
        n = cells // 3 if call == 0 else cells
        enc = sc.splat(n).numpy().view(np.uint32)
        slots = 400
        cell = rng.integers(0, n, slots)
        lo = rng.uniform(0.4, 4.0, slots).astype(np.float32)
        hi = lo + np.float32(0.5)
        ctas = -(-slots // rk.SPLAT_SLOTS)
        out = {}
        gens = [_cta_splat(list(zip(cell[i::ctas], lo[i::ctas],
                                    hi[i::ctas])), enc, n, ctas, out)
                for i in range(ctas)]
        _run(gens, rng)
        want_min = np.full(n, np.inf, np.float32)
        want_max = np.full(n, -np.inf, np.float32)
        np.minimum.at(want_min, cell, lo)
        np.maximum.at(want_max, cell, hi)
        np.testing.assert_array_equal(out["tmin"], want_min)
        np.testing.assert_array_equal(out["tmax"], want_max)
        assert not sc.enc.any()
