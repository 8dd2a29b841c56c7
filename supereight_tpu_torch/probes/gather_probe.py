"""Gather-rate probe on the card: the port of
`scripts/pallas_gather_probe.py:main`, with the same four measurements.

* ``stream_{K}x{n}k`` for K = 1, 2, 4, 8: one 1M-element gather against K
  independent 1M/K gathers from separate 1M-float tables, all consumed by
  one sum (do independent gather streams overlap?).  Plain torch indexing,
  as the JAX probe used XLA's gather.
* ``lane_shuffle_sum_256x128x64``: K2 (`ops/gather_probe.lane_shuffle_sum`),
  2.1M per-lane gathers from shared memory.
* ``slab_row_sum_2048x8x512``: K3 (`ops/gather_probe.slab_row_sum`), 2048
  random 8x512 slab loads from an L2-resident bf16 [6144, 512] table;
  ``ns_per_elem`` is ns per slab.
* ``fine_direct_14x19k``: plain torch indexing of the flat bf16 table at
  the fine raycast scan's shapes (14 samples x 19200 rays).

``src``, ``idxt``, ``table16`` and ``rows0`` (and the tables and carries)
are drawn from ``np.random.default_rng(7)`` in the JAX script's order, so
that both probes see the same data; ``jax.random.bits`` becomes a seeded
``torch.Generator``.  Each measurement is the median device time of one of
R = 64 runs, timed by CUDA events with the runs queued behind a sleeping
kernel (the JAX probe timed a ``lax.scan`` on the wall clock, a workaround
for its TPU's remote link).  The stream and fine-scan runs XOR a per-run
carry into their indices, as the JAX steps did; K2 and K3 take per-run
inputs made before the timing, so that their times are the kernels'.

Run on a CUDA device:  python -m supereight_tpu_torch.probes.gather_probe
[--out PATH].  It prints one JSON object and writes it to PATH only when
``--out`` is given.  A kernel failure fails the run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict

import numpy as np
import torch

from supereight_tpu_torch.ops import gather_probe as gp
from .timing import device_times_ms

R = 64                       # timed runs per measurement
N_STREAM = 1 << 20           # gathered elements per stream measurement
STREAMS = (1, 2, 4, 8)
S, KREP = 256, 64            # K2: rows x lanes x in-kernel repetitions
CAP, WIDE = 6144, 512        # K3: brick table
N_ROWS = 2048                # K3: slabs per launch
K_S, NRAY = 14, 19200        # fine scan: samples x rays
#: K2's and K3's second shapes, where the work outweighs a launch's fixed
#: cost: rows of K2 (krep KREP) and slabs of K3 (four of the probe's runs)
K2_SCALE_ROWS = 65536
K3_SCALE_RUNS = 4


def make_data(seed: int = 7) -> Dict[str, object]:
    """The JAX probe's inputs, drawn in its order (numpy arrays; each
    ``carry_*`` is the first of the 32 carries a measurement drew)."""
    rng = np.random.default_rng(seed)
    carry = lambda: int(rng.integers(0, 1 << 20, (32,))[0])
    d: Dict[str, object] = {}
    d["tables"] = [rng.standard_normal((N_STREAM,)).astype(np.float32)
                   for _ in range(max(STREAMS))]
    d["carry_stream"] = {K: carry() for K in STREAMS}
    d["src"] = rng.standard_normal((S, gp.LANES)).astype(np.float32)
    d["idxt"] = rng.integers(0, gp.LANES, (S, gp.LANES)).astype(np.int32)
    d["carry_shuffle"] = carry()
    d["table16"] = rng.standard_normal((CAP, WIDE)).astype(np.float32)
    d["rows0"] = (rng.integers(0, CAP // 8, (N_ROWS,)) * 8).astype(np.int32)
    d["carry_rows"] = carry()
    d["carry_fine"] = carry()
    return d


def shuffle_inputs(d, runs: int, device) -> torch.Tensor:
    """int32[runs, S, 128]: run r's lane indices ``idxt + carry + r``
    (the JAX step's ``idxt + idx[0]``; the timed scan started at carry +
    1)."""
    c = d["carry_shuffle"] + 1 + np.arange(runs, dtype=np.int64)
    idx = d["idxt"][None].astype(np.int64) + c[:, None, None]
    return torch.from_numpy(idx.astype(np.int32)).to(device)


def rows_inputs(d, runs: int, device) -> torch.Tensor:
    """int32[runs, N_ROWS]: run r's slab rows, the JAX step's
    ``((rows0 + (carry & 7) * 8) % (CAP - 8)) // 8 * 8``."""
    c = d["carry_rows"] + 1 + np.arange(runs, dtype=np.int64)
    rr = (d["rows0"][None].astype(np.int64) + (c[:, None] & 7) * 8) \
        % (CAP - 8)
    return torch.from_numpy(((rr // 8) * 8).astype(np.int32)).to(device)


def table16(d, device) -> torch.Tensor:
    return torch.from_numpy(d["table16"]).to(device).to(torch.bfloat16)


def kernel_inputs(device):
    """K2's and K3's inputs at the probe's shapes and at their second
    shapes, as ``chip_smoke.py`` holds them against their twins and
    ``probes/kernel_times.py`` times them: ``([(src, idx) at S rows, (src,
    idx) at K2_SCALE_ROWS rows], table, [rows of N_ROWS slabs, rows of
    K3_SCALE_RUNS * N_ROWS slabs])``.  The second K2 shape draws from
    ``default_rng(7)`` afresh, lane indices over all of int32."""
    d = make_data()
    rng = np.random.default_rng(7)
    big = (K2_SCALE_ROWS, gp.LANES)
    k2 = [(torch.from_numpy(d["src"]).to(device),
           shuffle_inputs(d, 1, device)[0]),
          (torch.from_numpy(rng.standard_normal(big).astype(np.float32))
           .to(device),
           torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, big)
                            .astype(np.int32)).to(device))]
    k3 = [rows_inputs(d, 1, device)[0],
          rows_inputs(d, K3_SCALE_RUNS, device).reshape(-1).contiguous()]
    return k2, table16(d, device), k3


def _bits(seed: int, shape, device) -> torch.Tensor:
    """Uniform uint32 bits (as int64) from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                         dtype=torch.int64)


def _median_ms(fn, runs: int) -> float:
    return statistics.median(device_times_ms(fn, runs))


def _runner(step, first: int):
    """``fn()`` calling ``step(carry)`` with carry = first, first + 1, ..."""
    box = [first]

    def fn():
        out = step(box[0])
        box[0] += 1
        return out
    return fn


def measure(device, runs: int = R) -> Dict[str, Dict[str, float]]:
    """All four measurements on ``device`` (a CUDA device)."""
    d = make_data()
    res: Dict[str, Dict[str, float]] = {}

    def record(name, ms, n_elems, **extra):
        res[name] = dict(ms=ms, ns_per_elem=ms * 1e6 / n_elems, **extra)
        print(f"# {name:30s} {ms:9.4f} ms {ms * 1e6 / n_elems:9.3f} "
              "ns/elem", file=sys.stderr)

    tables = [torch.from_numpy(t).to(device) for t in d["tables"]]
    for K in STREAMS:
        n_k = N_STREAM // K
        bases = [_bits(j, (n_k,), device) for j in range(K)]

        def step(c, bases=bases):
            tot = torch.zeros((), dtype=torch.float32, device=device)
            for j, base in enumerate(bases):
                tot = tot + tables[j][(base ^ c) % N_STREAM].sum()
            return tot
        record(f"stream_{K}x{n_k // 1024}k",
               _median_ms(_runner(step, d["carry_stream"][K] + 1), runs),
               N_STREAM)

    src = torch.from_numpy(d["src"]).to(device)
    idx = shuffle_inputs(d, runs + 1, device)
    record(f"lane_shuffle_sum_{S}x{gp.LANES}x{KREP}",
           _median_ms(_runner(lambda r: gp.lane_shuffle_sum(src, idx[r],
                                                            KREP), 0), runs),
           S * gp.LANES * KREP)

    tab = table16(d, device)
    rows = rows_inputs(d, runs + 1, device)
    record(f"slab_row_sum_{N_ROWS}x8x{WIDE}",
           _median_ms(_runner(lambda r: gp.slab_row_sum(rows[r], tab), 0),
                      runs),
           N_ROWS, note="ns_per_elem is ns per 8x512 slab")

    flat16 = tab.reshape(-1)
    base = _bits(9, (K_S, NRAY), device)
    record(f"fine_direct_{K_S}x{NRAY // 1000}k",
           _median_ms(_runner(lambda c: flat16[(base ^ c) % (CAP * WIDE)]
                              .sum().to(torch.float32),
                              d["carry_fine"] + 1), runs),
           K_S * NRAY)
    return res


def main(argv=None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: no CUDA device; the probe times the "
                         "card")
    res = measure(torch.device("cuda", 0))
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
