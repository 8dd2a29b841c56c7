"""The fusion kernels' instruction counts (`probes/sass_count.py`) on a
small hand-written SASS listing laid out as ``csrc/integrate.cu``'s kernels
compile: an early return, thread 0's set-up, four guarded voxel updates,
the ``__syncthreads_or``, the channel stores, and a slow-path subroutine."""

import pytest
import torch

from supereight_tpu_torch.probes import sass_count as sc

_BODY = [
    "S2R R0, SR_TID.X",
    "@P0 EXIT",                                   # a slot that is not live
    "@P1 BRA 0x60",                               # threads other than 0
    "STS [R0], R1",
    "IADD3 R1, R1, 0x1, RZ",
    "STS [R0+0x4], R1",
    "BAR.SYNC.DEFER_BLOCKING 0x0",
] + [x for j in range(4) for x in (
    f"@P2 BRA 0x{0xa0 + 0x30 * j:x}",             # voxel j does not fuse
    "MUFU.RSQ R2, R3",
    "FADD R4, R4, R2")] + [
    "BAR.RED.OR.DEFER_BLOCKING 0x0, P6",
    "@!P3 EXIT",                                  # nothing updated
    "STG.E.128 desc[UR4][R2.64], R8",
    "STG.E.128 desc[UR4][R4.64], R12",
    "EXIT",
    "BRA 0x180",
    "MUFU.RCP R0, R0",
    "RET.REL.NODEC R2 0x0",
    "NOP",
]
SASS = "\tFunction : _ZN4anon11fuse_kernelINS_9SdfUpdateEEEvNS_5TableET_\n" \
    + "".join(f"        /*{16 * i:04x}*/    {x} ;    /* 0x0 */\n"
              for i, x in enumerate(_BODY))


def _body():
    main, subs = sc.parse(SASS)["fuse_sdf"]
    return main, subs


def test_parse_splits_main_body_and_subroutines():
    main, subs = _body()
    assert len(main) == 24 and main[-1] == (0x170, "EXIT")
    assert [x for _, x in subs] == ["BRA 0x180", "MUFU.RCP R0, R0",
                                    "RET.REL.NODEC R2 0x0"]
    assert sc.count(main, subs) == dict(main=24, subroutines=3, mufu=4,
                                        fchk=0)
    wp = sc.waypoints(main)
    assert wp == dict(sync=19, store=21, setup=[3, 5],
                      update=[8, 11, 14, 17])


@pytest.mark.parametrize("through,want", [
    ([], 2),                                      # returns at once
    (["sync"], 10),                               # projects only
    (["sync", "store", 0, 1, 2, 3], 21),          # updates all four, stores
    (["sync", "store", "setup", 0, 1, 2, 3], 24),  # and thread 0's set-up
    (["sync", "setup", 1], 15),                   # set-up, voxel 1, no store
])
def test_min_issue_counts_the_shortest_path(through, want):
    main, _ = _body()
    wp, succ = sc.waypoints(main), sc.successors(main)
    pick = lambda t: ([wp["update"][t]] if isinstance(t, int) else
                      wp["setup"] if t == "setup" else [wp[t]])
    assert sc.min_issue(succ, [i for t in through for i in pick(t)]) == want


def test_issue_lower_bound_sums_warp_classes():
    main, _ = _body()
    called = torch.zeros(2, 512, dtype=torch.bool)
    called[0, 5] = True                 # thread 1 (warp 0), its voxel 1
    called[1, 4 * 40 + 2] = True        # thread 40 (warp 1), its voxel 2
    updated = called.clone()
    updated[1] = False                  # row 1's update changed nothing
    classes = sc.warp_classes(called, updated)
    assert classes == {(True, True, (1,)): 1, (False, False, ()): 5,
                       (True, False, ()): 1, (False, False, (2,)): 1}
    # set-up + voxel 1 + store: 18; projection only: 10; set-up only: 13;
    # voxel 2 without a store: 12; two dead warps: 2 each
    want = 18 + 5 * 10 + 13 + 12 + 2 * 2
    got = sc.issue_lower_bound_ms(main, classes, 2, 1e6)
    assert got == pytest.approx(1e3 * want / 1e6)
