"""decode.mfu.serve (read through decode.mfu.cli in a single-stream cell): the
whole decode step's share of the card's peak (%): the model FLOPs of every
decode step of the window (projections, attention and LM heads, counted from
shapes at each live request's position) over the window's wall time at 989
TFLOP/s (bf16 dense). Traced runs, where each chunk's positions are read."""
from port_bench import roofline as rl
from port_bench.layers import in_window, steps_of, step_work


def read(run):
    if not run.trace_on:
        return None
    spans = in_window(run, "engine.step") or in_window(run, "runner.generate")
    flops = 0.0
    for s in spans:
        for positions in steps_of(run, [s]):
            flops += sum(f for f, _ in step_work(run, positions, s).values())
    w0, w1 = run.window
    if not flops:
        return None
    return 100.0 * flops / ((w1 - w0) * rl.PEAK_FLOPS)
