"""GGUF v2/v3 reader with zero-copy mmap of tensor payloads.

Counterpart of the reference's `gguf_init_from_file` + `llama_mmap` loader
path (reference: src/models/loaders.cpp:45-69, ggml-patches/llama-mmap.h).
Tensor payloads are exposed as numpy views into the mmap'd file; quantized
payloads stay in their raw block format until the model loader decides
whether to dequantize on host or re-pack planar for the on-device dequant
kernels. A copy of the JAX package's reader.
"""
from __future__ import annotations

import dataclasses
import mmap
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from . import quants

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
    T_I64: "<q", T_F64: "<d",
}


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]  # numpy order: last dim contiguous (= ggml ne[0])
    ggml_type: int
    offset: int  # into the data section
    nbytes: int

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def type_name(self) -> str:
        return quants.TYPE_NAMES.get(self.ggml_type, str(self.ggml_type))


class GGUFReader:
    """Parse a GGUF file; mmap the tensor data section."""

    def __init__(self, path: str, use_mmap: bool = True):
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, TensorInfo] = {}
        self._order: List[str] = []
        self._f = open(path, "rb")
        if use_mmap:
            self._mm: Any = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        else:
            self._mm = self._f.read()
        self._parse()

    # -- binary cursor helpers ------------------------------------------------
    def _parse(self) -> None:
        buf = self._mm
        pos = 0

        def read(fmt: str):
            nonlocal pos
            size = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, buf, pos)
            pos += size
            return vals[0] if len(vals) == 1 else vals

        def read_str() -> str:
            nonlocal pos
            n = read("<Q")
            s = bytes(buf[pos:pos + n]).decode("utf-8", errors="replace")
            pos += n
            return s

        def read_value(vtype: int):
            if vtype in _SCALAR_FMT:
                return read(_SCALAR_FMT[vtype])
            if vtype == T_BOOL:
                return bool(read("<B"))
            if vtype == T_STR:
                return read_str()
            if vtype == T_ARR:
                etype = read("<I")
                count = read("<Q")
                if etype in _SCALAR_FMT and etype != T_F64:
                    # bulk numpy read for speed (voice tensors etc. are large)
                    dt = np.dtype(_SCALAR_FMT[etype][1:]).newbyteorder("<")
                    nonlocal pos
                    arr = np.frombuffer(buf, dtype=dt, count=count, offset=pos).copy()
                    pos += int(arr.nbytes)
                    return arr
                return [read_value(etype) for _ in range(count)]
            raise ValueError(f"bad gguf value type {vtype}")

        magic = read("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic:#x})")
        version = read("<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        self.version = version
        n_tensors = read("<Q")
        n_kv = read("<Q")

        for _ in range(n_kv):
            key = read_str()
            vtype = read("<I")
            self.metadata[key] = read_value(vtype)

        align = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        infos = []
        for _ in range(n_tensors):
            name = read_str()
            n_dims = read("<I")
            ne = [read("<Q") for _ in range(n_dims)]
            ggml_type = read("<I")
            offset = read("<Q")
            # gguf stores ne[0] first (contiguous dim); numpy wants it last.
            shape = tuple(reversed(ne)) if ne else (1,)
            nbytes = quants.nbytes_for(ggml_type, int(np.prod(shape)))
            infos.append(TensorInfo(name, shape, ggml_type, offset, nbytes))

        pos = (pos + align - 1) // align * align
        self.data_start = pos
        for ti in infos:
            self.tensors[ti.name] = ti
            self._order.append(ti.name)

    # -- public API ------------------------------------------------------------
    @property
    def architecture(self) -> str:
        return str(self.metadata.get("general.architecture", ""))

    def tensor_names(self) -> List[str]:
        return list(self._order)

    def raw(self, name: str) -> np.ndarray:
        """Raw payload bytes as a zero-copy uint8 view into the mmap."""
        ti = self.tensors[name]
        start = self.data_start + ti.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)

    def array(self, name: str) -> np.ndarray:
        """Tensor as float32/int numpy array (dequantized if needed)."""
        ti = self.tensors[name]
        if ti.ggml_type == quants.GGML_TYPE_F32:
            return np.frombuffer(self._mm, dtype=np.float32, count=ti.n_elems,
                                 offset=self.data_start + ti.offset).reshape(ti.shape)
        if ti.ggml_type == quants.GGML_TYPE_F16:
            return np.frombuffer(self._mm, dtype=np.float16, count=ti.n_elems,
                                 offset=self.data_start + ti.offset).reshape(ti.shape)
        if ti.ggml_type == quants.GGML_TYPE_I32:
            return np.frombuffer(self._mm, dtype=np.int32, count=ti.n_elems,
                                 offset=self.data_start + ti.offset).reshape(ti.shape)
        return quants.dequantize(self.raw(name), ti.ggml_type, ti.n_elems).reshape(ti.shape)

    def planar(self, name: str):
        """Quantized tensor -> (codes, scales) planar arrays for device dequant."""
        ti = self.tensors[name]
        return quants.unpack_planar(self.raw(name), ti.ggml_type, ti.shape)

    def get(self, key: str, default=None):
        return self.metadata.get(key, default)

    def first_key(self, keys, default=None):
        """Multi-key fallback lookup (reference `search_for_gguf_keys`, src/util.cpp:55-64)."""
        for k in keys:
            if k in self.metadata:
                return self.metadata[k]
        return default

    def close(self) -> None:
        if isinstance(self._mm, mmap.mmap):
            try:
                self._mm.close()
            except BufferError:
                pass  # zero-copy views still alive; mmap freed with them
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
