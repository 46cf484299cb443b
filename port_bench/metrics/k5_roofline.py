"""k5_roofline: K5's GEMV launches (csrc/parler_megastep.cu): a Parler step's eight projections of every layer, read once a step for all slots. Its share of the roofline (%), over the traced
window's whole decode chunks or requests (layers.roofline_share)."""
from port_bench.layers import roofline_share


def read(run):
    return roofline_share(run, "k5")
