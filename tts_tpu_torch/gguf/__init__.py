from . import quants  # noqa: F401
from .reader import GGUFReader, TensorInfo  # noqa: F401
from .writer import GGUFWriter  # noqa: F401
