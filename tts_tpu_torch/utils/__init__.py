from .profiling import StageTimer, trace  # noqa: F401
