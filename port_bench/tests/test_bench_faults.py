"""The correctness check fails a broken program: each fault planted in the
timed path of each cell, at a tiny size on the CPU, turns `correct` false,
and the control (the reference in fp8 where the program rounds to
bfloat16) comes out not correct by the harness's own comparison, both at
the tiny size and, from its readings on the card, at each cell's committed
limits."""
import pytest

from port_bench import common, harness
from port_bench.faults import FAULTS
from port_bench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in common.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(workload, fault):
    res = harness.run(tiny_cell(workload), 11, 4.0, 0, device="cpu",
                      fault=FAULTS[fault], drain_s=3.0)
    assert res["correct"] is False
    broken = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert broken


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    res = harness.run(tiny_cell(workload), 13, 4.0, 0, device="cpu",
                      control=True)
    assert res["correct"] is True, res["checks"]
    ctl = res["control"]
    assert ctl["control_correct"] is False, ctl
    assert ctl["control_correct_f32_dac"] is False, ctl
    prog, ctrl = ctl["program"], ctl["control"]
    for n in harness.LOGIT_READINGS:
        if n in prog:
            assert ctrl[n] >= 3 * prog[n] and ctrl[n] > 0, (n, ctl)


@pytest.mark.parametrize("workload", CELLS)
def test_committed_limits_fail_the_control(workload):
    """Each cell's limits against the readings they were set from on the
    card (limits/<cell>.json): the program's highest pass, the control's
    lowest fail, with the DAC in TF32 and with it in float32."""
    cell = common.Cell(common.benchmark(), workload)
    limits = harness.cell_limits(cell)
    kept = common.load_json(common.BENCH_DIR / "limits" / f"{workload}.json")
    prog = {n: hi for n, (lo, hi) in kept["readings"]["program"].items()}
    ctrl = {n: lo for n, (lo, hi) in kept["readings"]["control"].items()}
    assert set(prog) == set(ctrl) == set(limits)
    assert harness.verdict(prog, limits)
    assert not harness.verdict(ctrl, limits)
    assert not harness.verdict({n: ctrl[n] for n in harness.LOGIT_READINGS
                                if n in ctrl}, limits)
