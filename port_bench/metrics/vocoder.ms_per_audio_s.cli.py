"""vocoder.ms_per_audio_s.cli: vocoder.ms_per_audio_s.serve's reading in a single-stream cell, where it
moves audio_s_per_wall_s."""
from port_bench import common

read = common.metric_reader("vocoder.ms_per_audio_s.serve").read
