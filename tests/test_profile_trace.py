"""The trace reduction of scripts/profile_trace.py on small recorded events:
device busy time as a union of intervals, and stage attribution through the
optimized HLO's named-scope metadata."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import profile_trace as pt  # noqa: E402


def test_busy_is_union_of_intervals():
    events = [("a", "", 0, 10), ("b", "", 5, 12), ("c", "", 20, 30), ("d", "", 21, 22)]
    assert pt.busy_ns(events) == 22
    assert pt.busy_ns([("a", "", 3, 4)]) == 1


def test_stage_attribution_from_hlo_metadata():
    hlo = "\n".join([
        '  loop_add_fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, calls=%f, '
        'metadata={op_name="jit(step)/branch_1_fun/pose_solve/lm_linear_solve/add"}',
        '  custom-call.5 = f32[8]{0} custom-call(%a), custom_call_target="__gpu$xla.gpu.triton", '
        'metadata={op_name="jit(step)/branch_1_fun/klt_track/pallas_call"}, '
        'backend_config={"name":"klt_pyramid_anchored"}',
        "  copy.1 = f32[8]{0} copy(%a)",
    ])
    scopes = pt.scope_map(hlo)
    # the innermost stage of the scope path wins
    assert pt.classify(scopes["loop_add_fusion.3"]) == "lm_linear_solve"
    # a kernel launched from a command buffer is found by its kernel spelling
    assert pt.classify(scopes["loop_add_fusion_3"]) == "lm_linear_solve"
    assert pt.classify(scopes["klt_pyramid_anchored"]) == "klt_track"
    assert "copy.1" not in scopes
    assert pt.classify("jit(step)/something_else") == "other"
