"""k1_roofline.serve (read through k1_roofline.cli in a single-stream cell): K1
(csrc/quant_matmul.cu), the block-quantized matmul of the LM heads every
step and of Parler's prefills. Its share of the roofline (%): each launch's
least time, from the program's census of K1's shapes (`quant_matmul.SHAPES`)
over the whole traced session (synchronized at its end, so that a prefill
launched at a chunk's end is in it), over the time K1's kernels ran in the
session. None where K1 did not run."""
from port_bench import roofline as rl


def read(run):
    if run.trace is None:
        return None
    least = sum(n * rl.bound_s(*rl.k1_call(*shape))
                for shape, n in run.k1_shapes.items())
    busy = run.trace.busy_s(names=rl.KERNELS["k1"])
    return 100.0 * least / busy if least > 0 and busy > 0 else None
