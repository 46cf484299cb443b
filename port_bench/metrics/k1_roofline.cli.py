"""k1_roofline.cli: k1_roofline.serve's reading in a single-stream cell, where it
moves audio_s_per_wall_s."""
from port_bench import common

read = common.metric_reader("k1_roofline.serve").read
