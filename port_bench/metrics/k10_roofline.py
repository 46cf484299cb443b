"""k10_roofline: K10 (csrc/dia_flat.cu): Dia's whole decoder layer stack in one cooperative launch a step, the single stream. Its share of the roofline (%), over the traced
window's whole decode chunks or requests (layers.roofline_share)."""
from port_bench.layers import roofline_share


def read(run):
    return roofline_share(run, "k10")
