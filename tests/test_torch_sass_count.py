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


def test_waypoints_skip_the_node_cells():
    """A body laid out as the fusion with the node pyramid's CTAs in its
    launch compiles: a branch to the node cells at the entry (their own
    set-up, barrier, update's ``MUFU.RSQ``, store and exit), then the
    row's code.  The row's waypoints are the same, the nodes' skipped."""
    import re
    node = ["ISETP.GE.AND P4, PT, R0, R5, PT",
            "@!P4 BRA 0x80",                      # a row's CTA
            "STS [R0], R9",                       # T_cw and K
            "BAR.SYNC.DEFER_BLOCKING 0x0",
            "MUFU.RSQ R6, R7",
            "STG.E desc[UR4][R8.64], R6",
            "EXIT",
            "NOP R0"]
    # the row's code 0x80 further on, its branches with it
    row = [re.sub(r"BRA 0x([0-9a-f]+)",
                  lambda t: f"BRA 0x{int(t.group(1), 16) + 0x80:x}", x)
           for x in _BODY[:24]]
    body = [(16 * i, x) for i, x in enumerate(node + row)]
    assert body[len(node)][0] == 0x80
    wp = sc.waypoints(body)
    assert wp == dict(sync=19 + len(node), store=21 + len(node),
                      setup=[3 + len(node), 5 + len(node)],
                      update=[8 + len(node) + 3 * j for j in range(4)])


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


@pytest.mark.parametrize("branch,want", [
    ("BRA 0x40", [4]),                  # always taken
    ("@P0 BRA 0x40", [2, 4]),           # guarded: falls through or taken
    ("@!P5 BRA P6, 0x40", [2, 4]),      # and testing a second predicate
    ("BRA P6, 0x40", [2, 4]),
    ("BRA PT, 0x40", [4]),
])
def test_successors_of_a_branch(branch, want):
    body = [(0x00, "S2R R0, SR_TID.X"), (0x10, branch), (0x20, "IADD3 R1"),
            (0x30, "NOP R2"), (0x40, "EXIT")]
    assert sc.successors(body)[1] == want


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


@pytest.mark.parametrize("func,name", [
    ("_ZN4anon11fuse_kernelINS_9SdfUpdateEEEvNS_5TableET_", "fuse_sdf"),
    ("_ZN4anon11fuse_kernelINS_12OFusionUpdateEEEvNS_5TableET_",
     "fuse_ofusion"),
    ("_ZN48_GLOBAL__N__0a9509dc_15_gather_probe_cu_f838b53023lane_shuffle_"
     "sum_kernelILi64EEEvPKfPKiPfii", "lane_shuffle_sum<64>"),
    ("_ZN48_GLOBAL__N__0a9509dc_15_gather_probe_cu_f838b53023lane_shuffle_"
     "sum_kernelILin1EEEvPKfPKiPfii", "lane_shuffle_sum<-1>"),
    ("_ZN48_GLOBAL__N__0a9509dc_15_gather_probe_cu_f838b53019slab_row_sum_"
     "kernelEPKiPKtPfiii", "slab_row_sum"),
    ("_ZN48_GLOBAL__N__0a9509dc_15_gather_probe_cu_f838b53012empty_kernelEv",
     "empty"),
    ("_ZN46_GLOBAL__N__3e1f0c2a_11_numerics_cu_5b1a7d3c14inverse_kernelILi4EE"
     "EvPKfPf", "inverse<4>"),
    ("_ZN45_GLOBAL__N__7c1e2f0a_10_raycast_cu_9d2b4e1119splat_bounds_kernel"
     "ENS_5SplatE", "splat_bounds"),
    ("_ZN45_GLOBAL__N__7c1e2f0a_10_raycast_cu_9d2b4e1115ray_scan_kernelENS_4"
     "RaysE", "ray_scan"),
    ("_ZN45_GLOBAL__N__7c1e2f0a_10_raycast_cu_9d2b4e1125ray_refine_normals_"
     "kernelENS_6FinishE", "ray_refine_normals"),
    ("_ZN47_GLOBAL__N__5d2c8e1a_12_integrate_cu_0b7f3a2e21frustum_select_"
     "kernelENS_6SelectE", "frustum_select"),
    ("_ZN41_GLOBAL__N__9e3a1c7b_6_icp_cu_4c2d8f1023icp_track_reduce_kernelE"
     "NS_5LevelENS_5KnobsEPKfNS_5CarryEifS4_PiPfPjS7_", "icp_track_reduce"),
])
def test_kernel_names(func, name):
    assert sc.kernel_name(func) == name


# a chunk loop around a stage loop, laid out as csrc/gather_probe.cu's K3
# compiles: copies skipped on a branch, a spin wait, two shared loads and
# adds, a barrier; then the self-branch after the EXIT
_LOOP = [
    "S2R R0, SR_TID.X",                               # 0
    "BAR.SYNC.DEFER_BLOCKING 0x0",                    # 1 chunk loop
    "LDS R2, [R0]",                                   # 2 stage loop
    "@P0 BRA 0x50",                                   # 3 no copies
    "LDGSTS.E.BYPASS.128 [R1], desc[UR4][R2.64]",     # 4
    "LDGDEPBAR",                                      # 5
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R3], R4",    # 6 spin wait
    "@!P1 BRA 0x60",                                  # 7
    "LDS.U16 R5, [R6]",                               # 8
    "LDS.U16 R7, [R6+0x100]",                         # 9
    "FADD R8, R8, R5",                                # 10
    "FADD R8, R8, R7",                                # 11
    "BAR.SYNC.DEFER_BLOCKING 0x0",                    # 12
    "@P2 BRA 0x20",                                   # 13 next stage
    "@P3 BRA 0x10",                                   # 14 next chunk
    "EXIT",                                           # 15
    "BRA 0x100",                                      # 16
]
LOOP_SASS = "\tFunction : _ZN4anon19slab_row_sum_kernelEPKiPKtPfiii\n" \
    + "".join(f"        /*{16 * i:04x}*/    {x} ;    /* 0x0 */\n"
              for i, x in enumerate(_LOOP))


@pytest.mark.parametrize("op,at_least,through,want", [
    ("LDS.U16", 2, (), 11),            # the stage loop, copies skipped
    ("LDS.U16", 2, ("LDGSTS",), 12),   # through the copy
    ("BAR", 2, (), 13),                # only the chunk loop holds two
    ("FADD", 2, ("SYNCS",), 11),
])
def test_loop_trip_counts_the_shortest_trip(op, at_least, through, want):
    main, subs = sc.parse(LOOP_SASS)["slab_row_sum"]
    assert len(main) == len(_LOOP) and not subs
    assert sc.loop_trip(main, op, at_least, through) == want


def test_loop_trip_needs_a_loop_holding_the_run():
    main, _ = sc.parse(LOOP_SASS)["slab_row_sum"]
    with pytest.raises(ValueError):
        sc.loop_trip(main, "LDS.U16", 3)


def test_loop_issue_lower_bound():
    # 300 instructions a trip, 4 warps x 65536 rows, 132 SMs x 4
    # schedulers at 1980 MHz
    rate = 132 * 4 * 1980e6
    got = sc.loop_issue_lower_bound_ms(300, 4 * 65536, rate)
    assert got == pytest.approx(1e3 * 300 * 4 * 65536 / rate)
    assert 0.075 < got < 0.076


# -Xptxas -v's output as nvcc prints it for two entry functions, the second
# with a stack frame and spills
_PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z14inverse_kernelILi4EEvPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z14inverse_kernelILi4EEvPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 0 barriers, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14inverse_kernelILi8EEvPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z14inverse_kernelILi8EEvPKfPf
    264 bytes stack frame, 40 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 368 bytes cmem[0]
"""


def test_ptxas_properties():
    props = sc.ptxas_properties(_PTXAS)
    assert props == {
        "_Z14inverse_kernelILi4EEvPKfPf": dict(
            stack=0, spill_stores=0, spill_loads=0, registers=38),
        "_Z14inverse_kernelILi8EEvPKfPf": dict(
            stack=264, spill_stores=40, spill_loads=36, registers=255)}


def test_local_memory_ops():
    body = [(0, "LDG.E R2, desc[UR4][R2.64]"), (16, "STL [R1], R2"),
            (32, "@P0 LDL.64 R4, [R1+0x8]"), (48, "LDS R6, [R0]"),
            (64, "EXIT")]
    assert sc.local_memory_ops({"a": (body, [(80, "STL.128 [R1], R8")]),
                                "b": (body[3:], [])}) == dict(a=3, b=0)
