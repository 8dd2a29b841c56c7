"""Instruction counts of the kernels from their compiled code, and the least
time a launch's warps take to issue their instructions.

``cuobjdump -sass`` lists the machine code (SASS) of each kernel in the
built ``csrc/integrate.cu``.  For each kernel this counts the instructions
of its main body (up to the ``EXIT`` that ends it; the slow paths of IEEE
division and square root follow as subroutines and are counted apart), its
``MUFU`` (special-function) and ``FCHK`` (division range check)
instructions.

The issue lower bound (:func:`min_issue`): the fewest instructions a warp
can issue on any path through the main body's control flow from its entry
to an ``EXIT`` that passes given instructions in order.  A warp that
projects its voxels passes the ``__syncthreads_or`` (``BAR.RED``); one
where some thread updates voxel j of its four passes that update's square
root (the main body's j-th ``MUFU.RSQ``); one that stores passes the
16-byte channel store (``STG.E.128``); the warp that holds thread 0 passes
its shared-memory stores of the row's parameters (``STS``).  Predicated
instructions count (they issue), a call to a slow path counts as one
instruction, and each of an SM's four schedulers issues at most one warp
instruction a clock.  ``chip_smoke.py`` sorts the warps of a launch into
these classes from the run's data (:func:`warp_classes`) and sums the
bound (:func:`issue_lower_bound_ms`).

The gather-probe kernels (``csrc/gather_probe.cu``) spend their time in one
loop each: :func:`loop_trip` counts the fewest instructions a warp issues
in one trip of the innermost loop that holds a given instruction run (K2's
64 shared loads of a row; K3's 32 shared loads of a stage, on a path
through the stage's copies), and
:func:`loop_issue_lower_bound_ms` multiplies it by the warp-trips the shapes
fix, at the same issue rate.

Run on a CUDA device:  python -m supereight_tpu_torch.probes.sass_count
[--out PATH].  It prints one JSON object: the counts, and the fewest
instructions of a warp that returns at once, one that only projects and
one that updates all four of its voxel lanes and stores; and the gather
kernels' loop trips.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Sequence, Tuple

from supereight_tpu_torch.ops.gather_probe import SLAB_STAGE

WARPS = 4                # a row's CTA of 128 threads
VOXELS_PER_THREAD = 4
SCHEDULERS_PER_SM = 4

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P\w+\s+")
_FUNC = re.compile(r"Function : (\S+)")
# a branch's target, after the predicate it may also test (``BRA P6, 0x..``)
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:(!?U?P\w+),\s*)?(0x[0-9a-f]+)")
_TEMPLATE = re.compile(r"_kernelILi(n?)(\d+)E")

#: the gather kernels' main loops, as `loop_trip` takes them: (instruction
#: prefix, how many of them the loop holds at least, prefixes of the
#: instructions a trip passes)
GATHER_LOOPS = {"lane_shuffle_sum<64>": ("LDS", 64, ()),
                "slab_row_sum": ("LDS.U16", SLAB_STAGE, ("LDGSTS",))}

#: (address, instruction) of a kernel's main body
Body = List[Tuple[int, str]]


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("cuobjdump not found: put it on PATH or set "
                           "CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "cuobjdump")


def _op(ins: str) -> str:
    return _PRED.sub("", ins).split()[0]


def kernel_name(func: str) -> str:
    """The package's name of a compiled (mangled) kernel: ``fuse_sdf`` and
    ``fuse_ofusion`` by their update, ``lane_shuffle_sum<64>`` for a
    template argument, the raycast's, the selection's and the sharded ICP
    trip's by their entry points, else the function's own name."""
    if "OFusion" in func:
        return "fuse_ofusion"
    if "Sdf" in func:
        return "fuse_sdf"
    for name in ("lane_shuffle_sum", "slab_row_sum", "empty", "inverse",
                 "splat_bounds", "ray_scan", "ray_refine_normals",
                 "frustum_select", "icp_track_reduce"):
        if name + "_kernel" in func:
            m = _TEMPLATE.search(func)
            if m is None:
                return name
            return f"{name}<{'-' if m.group(1) else ''}{m.group(2)}>"
    return func


def parse(sass: str) -> Dict[str, Tuple[Body, Body]]:
    """{kernel: (main body, subroutines)}, each a list of (address,
    instruction) as printed (NOPs skipped).  The main body ends at the last
    unpredicated ``EXIT`` before the first ``RET`` (the slow paths of IEEE
    division and square root are subroutines after it)."""
    funcs: Dict[str, Body] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m is not None and cur is not None \
                and not _op(m.group(2)).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for func, ins in funcs.items():
        kernel = kernel_name(func)
        rets = [i for i, (_, x) in enumerate(ins) if _op(x).startswith("RET")]
        end = len(ins)
        if rets:
            end = max(i for i, (_, x) in enumerate(ins[:rets[0]])
                      if x == "EXIT") + 1
        out[kernel] = (ins[:end], ins[end:])
    return out


def count(main: Body, subs: Body) -> Dict[str, int]:
    return dict(main=len(main), subroutines=len(subs),
                mufu=sum(_op(x).startswith("MUFU") for _, x in main),
                fchk=sum(_op(x).startswith("FCHK") for _, x in main))


def successors(body: Body) -> List[List[int]]:
    """Each instruction's successors in the main body; -1 is the end (an
    ``EXIT`` taken)."""
    addrs = [a for a, _ in body]
    succ = []
    for i, (_, ins) in enumerate(body):
        op, pred = _op(ins), ins.startswith("@")
        nxt = [i + 1] if i + 1 < len(body) else []
        if op == "EXIT":
            succ.append(([i + 1] if pred and nxt else []) + [-1])
        elif op.startswith("BRA"):
            m = _TARGET.search(ins)
            if m is None:
                raise ValueError(f"branch without a target: {ins}")
            tgt = bisect.bisect_left(addrs, int(m.group(2), 16))
            cond = pred or m.group(1) not in (None, "PT")
            succ.append((nxt if cond else []) + [tgt])
        elif op.startswith(("BRX", "JMX", "JMP", "RET")):
            raise ValueError(f"indirect or returning branch in the main "
                             f"body: {ins}")
        else:
            succ.append(nxt)
    return succ


def _distances(succ: List[List[int]], src: int) -> Dict[int, int]:
    """Instructions issued from ``src`` (counted) to each reachable one
    (counted), and to the end (key -1)."""
    dist = {src: 1}
    queue = collections.deque([src])
    while queue:
        u = queue.popleft()
        for v in succ[u]:
            if v == -1:
                dist[-1] = min(dist.get(-1, dist[u]), dist[u])
            elif v not in dist:
                dist[v] = dist[u] + 1
                queue.append(v)
    return dist


def waypoints(body: Body) -> Dict[str, object]:
    """Indices in the main body of the instructions a row's warp class must
    pass: ``sync`` (``BAR.RED``), ``store`` (the first ``STG.E.128``),
    ``setup`` (thread 0's shared-memory stores of the row's parameters,
    every ``STS`` before the ``BAR.SYNC``) and ``update`` (the four
    ``MUFU.RSQ`` between the ``BAR.SYNC`` and the sync, voxel 0 to 3).  The
    node pyramid's CTAs, which branch away before the row's code, have
    their own set-up, barrier and updates, on no path to the sync."""
    find = lambda p: [i for i, (_, x) in enumerate(body)
                      if _op(x).startswith(p)]
    sync, store, bar, update = (find("BAR.RED"), find("STG.E.128"),
                                find("BAR.SYNC"), find("MUFU.RSQ"))
    setup = []
    if len(sync) == 1:
        # the row's: what lies on a path through its barrier to the sync
        succ = successors(body)
        reaches = lambda i, j: j in _distances(succ, i)
        bar = [b for b in bar if reaches(b, sync[0])]
        if bar:
            setup = [i for i in find("STS") if i < bar[0]
                     and reaches(i, bar[0])]
            update = [i for i in update
                      if reaches(bar[0], i) and reaches(i, sync[0])]
    if len(sync) != 1 or not store or len(bar) != 1 or not setup \
            or len(update) != VOXELS_PER_THREAD:
        raise ValueError(f"unexpected main body: {len(sync)} BAR.RED, "
                         f"{len(store)} STG.E.128, {len(bar)} BAR.SYNC, "
                         f"{len(setup)} STS before it, {len(update)} "
                         "MUFU.RSQ")
    return dict(sync=sync[0], store=store[0], setup=setup, update=update)


def min_issue(succ: List[List[int]], through: Sequence[int]) -> int:
    """Fewest instructions a warp issues from the main body's entry to an
    ``EXIT``, passing the instructions ``through`` in address order
    (``succ`` from :func:`successors`)."""
    total, at = 0, 0
    for w in tuple(sorted(through)) + (-1,):
        d = _distances(succ, at)
        if w not in d:
            raise ValueError(f"instruction {w} is not reachable from {at}")
        total += d[w] - (1 if total else 0)     # `at` is counted once
        at = w
    return total


def warp_classes(called, updated, first_warp=True):
    """Warp counts by class for rows that reach the sync: ``called`` bool
    [rows, 512] (the update was called: in frame, in the patch and a
    positive sample), ``updated`` bool[rows, 512] (the voxel's channels
    changed).  Returns {(setup, store, voxels j updated): warps}, where
    ``setup`` marks each row's first warp (thread 0's)."""
    import torch
    n = called.shape[0]
    j = called.view(n, WARPS, 32, VOXELS_PER_THREAD).any(2)     # [n, 4, 4]
    code = (j.long() * (1 << torch.arange(VOXELS_PER_THREAD,
                                          device=j.device))).sum(-1)
    code = code + 16 * updated.view(n, WARPS, -1).any(-1).long()
    if first_warp:
        code[:, 0] += 32
    hist = torch.bincount(code.flatten(), minlength=64).tolist()
    return {(bool(c & 32), bool(c & 16),
             tuple(k for k in range(VOXELS_PER_THREAD) if c >> k & 1)): h
            for c, h in enumerate(hist) if h}


def issue_lower_bound_ms(body: Body, classes, dead_warps: int,
                         issue_per_s: float) -> float:
    """Least time the launch's warps take to issue their instructions:
    each class's fewest instructions (:func:`min_issue`) times its warps,
    and ``dead_warps`` warps that return at once, over the card's issue
    rate (warp instructions a second)."""
    wp, succ = waypoints(body), successors(body)
    total = dead_warps * min_issue(succ, [])
    for (setup, store, upd), warps in classes.items():
        through = [wp["sync"]] + [wp["update"][j] for j in upd] \
            + ([wp["store"]] if store else []) \
            + (wp["setup"] if setup else [])
        total += warps * min_issue(succ, through)
    return 1e3 * total / issue_per_s


def loop_trip(body: Body, op: str, at_least: int,
              through: Sequence[str] = ()) -> int:
    """Fewest instructions a warp issues in one trip of the innermost loop
    (a backward branch and the instructions from its target to it) whose
    instructions include at least ``at_least`` with the prefix ``op``: the
    shortest path from the loop's first instruction to its branch, both
    counted, that passes the loop's first instruction with each prefix in
    ``through``."""
    succ = successors(body)
    loops = []
    for e, (_, ins) in enumerate(body):
        if not _op(ins).startswith("BRA"):
            continue
        h = succ[e][-1]                 # the taken branch's target
        n = sum(_op(x).startswith(op) for _, x in body[h:e + 1])
        if h <= e and n >= at_least:
            loops.append((e - h, h, e))
    if not loops:
        raise ValueError(f"no loop holds {at_least} {op} instructions")
    _, h, e = min(loops)
    stops = sorted(next(i for i in range(h, e + 1)
                        if _op(body[i][1]).startswith(p)) for p in through)
    total, at = 1, h
    for w in stops + [e]:
        d = _distances(succ, at)
        if w not in d:
            raise ValueError(f"instruction {w} is not reachable from {at}")
        total += d[w] - 1               # `at` is counted once
        at = w
    return total


def loop_issue_lower_bound_ms(trip: int, warp_trips: int,
                              issue_per_s: float) -> float:
    """Least time ``warp_trips`` trips of ``trip`` instructions take to
    issue at the card's issue rate (warp instructions a second)."""
    return 1e3 * trip * warp_trips / issue_per_s


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS_FOR = re.compile(r"Function properties for (\S+)")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_properties(log: str) -> Dict[str, Dict[str, int]]:
    """{function: its stack frame, spill stores and spill loads (bytes) and
    registers} from ``-Xptxas -v``'s output ``log``, by mangled name."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _PROPS_FOR.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PROPS.search(line)
        if m and props is not None:
            out.setdefault(props, {}).update(zip(
                ("stack", "spill_stores", "spill_loads"),
                map(int, m.groups())))
            continue
        m = _REGS.search(line)
        if m and entry is not None:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def ptxas_log(source: str) -> str:
    """``-Xptxas -v``'s output for ``csrc/<source>.cu``, built from the
    checkout's sources (the log ``_build`` keeps beside the library)."""
    from supereight_tpu_torch.ops import _build
    _build.load(source)
    lib = _build.library_path(source)
    return lib.with_name(lib.name + ".log").read_text()


def local_memory_ops(bodies: Dict[str, Tuple[Body, Body]]) -> Dict[str, int]:
    """{kernel: its local-memory loads and stores (``LDL``, ``STL``)}, main
    body and subroutines."""
    return {k: sum(_op(x).split(".")[0] in ("LDL", "STL")
                   for _, x in main + subs)
            for k, (main, subs) in bodies.items()}


def card_issue_rate() -> Tuple[str, float, float, int, float]:
    """(name, power limit W, max SM MHz, SMs, warp instructions a second at
    that clock, one a scheduler a clock)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    name, power, mhz = [x.strip() for x in smi.stdout.splitlines()[0]
                        .split(",")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (name, float(power), float(mhz), sms,
            sms * SCHEDULERS_PER_SM * float(mhz) * 1e6)


def kernel_bodies(source: str = "integrate") -> Dict[str, Tuple[Body, Body]]:
    """The SASS of ``csrc/<source>.cu``'s kernels, built from the
    checkout's sources."""
    from supereight_tpu_torch.ops import _build
    _build.load(source)
    sass = subprocess.run([_cuobjdump(), "-sass",
                           str(_build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return parse(sass)


def gather_trips() -> Dict[str, int]:
    """The instructions of one trip of each gather-kernel loop
    (`GATHER_LOOPS`)."""
    bodies = kernel_bodies("gather_probe")
    return {kernel: loop_trip(bodies[kernel][0], op, n, through)
            for kernel, (op, n, through) in GATHER_LOOPS.items()}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sass_count: no CUDA device")
    name, power, mhz, sms, _ = card_issue_rate()
    res: Dict[str, object] = dict(device=name, power_limit_w=power, sms=sms,
                                  max_sm_mhz=mhz, kernels={})
    for kernel, (main_body, subs) in kernel_bodies().items():
        if kernel not in ("fuse_sdf", "fuse_ofusion"):
            continue        # the frustum selection's two kernels
        c = count(main_body, subs)
        wp, succ = waypoints(main_body), successors(main_body)
        c["min_warp"] = dict(
            dead=min_issue(succ, []),
            project=min_issue(succ, [wp["sync"]]),
            fuse=min_issue(succ, [wp["sync"], wp["store"]]
                           + list(wp["update"])))
        res["kernels"][kernel] = c
    res["gather_loop_trips"] = gather_trips()
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
