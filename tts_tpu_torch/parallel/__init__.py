"""Parallelism on torch.distributed: process groups and meshes, Megatron
tensor parallelism for the Parler / Orpheus / Dia decode steps (K1 on every
shard), the weight-gather mode, the dp x tp batched Parler layout and the
sequence-parallel DAC decode."""
