"""k4_roofline: K4, the batched decode attention (csrc/decode_attention.cu): self-attention over each live slot's cache rows and the cross-attention, in the served cells. Its share of the roofline (%), over the traced
window's whole decode chunks or requests (layers.roofline_share)."""
from port_bench.layers import roofline_share


def read(run):
    return roofline_share(run, "k4")
