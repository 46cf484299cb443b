"""host.launches_per_step.cli: host.launches_per_step.serve's reading in a single-stream cell, where it
moves audio_s_per_wall_s."""
from port_bench import common

read = common.metric_reader("host.launches_per_step.serve").read
