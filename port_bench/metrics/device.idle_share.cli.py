"""device.idle_share.cli: device.idle_share.serve's reading in a single-stream cell, where it
moves audio_s_per_wall_s."""
from port_bench import common

read = common.metric_reader("device.idle_share.serve").read
