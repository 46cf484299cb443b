"""GGUF v3 writer.

Used by the quantizer tool (parity: reference examples/quantize/
quantize_impl.cpp:181-293 rewrites GGUF after quantization) and by the test
suite to fabricate tiny checkpoints (parity: py-gguf converters).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from . import quants
from .reader import (
    GGUF_MAGIC, DEFAULT_ALIGNMENT,
    T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR,
    T_U64, T_I64, T_F64, _SCALAR_FMT,
)

_NP_TO_GGML = {
    np.dtype(np.float32): quants.GGML_TYPE_F32,
    np.dtype(np.float16): quants.GGML_TYPE_F16,
    np.dtype(np.int32): quants.GGML_TYPE_I32,
}


def _encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _infer_vtype(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_I64 if (v < 0 or v >= 2**32) else T_U32
    if isinstance(v, float):
        return T_F32
    if isinstance(v, str):
        return T_STR
    raise TypeError(f"cannot infer gguf type for {type(v)}")


def _encode_value(v: Any, vtype: int) -> bytes:
    if vtype in _SCALAR_FMT:
        return struct.pack(_SCALAR_FMT[vtype], v)
    if vtype == T_BOOL:
        return struct.pack("<B", 1 if v else 0)
    if vtype == T_STR:
        return _encode_str(v)
    raise TypeError(f"bad vtype {vtype}")


class GGUFWriter:
    def __init__(self, path: str, architecture: str):
        self.path = path
        self.kv: List[Tuple[str, bytes]] = []
        self.tensors: List[Tuple[str, Tuple[int, ...], int, bytes]] = []
        self.add_str("general.architecture", architecture)

    # -- metadata --------------------------------------------------------------
    def _add(self, key: str, vtype: int, payload: bytes) -> None:
        self.kv.append((key, struct.pack("<I", vtype) + payload))

    def add_str(self, key: str, v: str) -> None:
        self._add(key, T_STR, _encode_str(v))

    def add_u32(self, key: str, v: int) -> None:
        self._add(key, T_U32, struct.pack("<I", v))

    def add_i32(self, key: str, v: int) -> None:
        self._add(key, T_I32, struct.pack("<i", v))

    def add_f32(self, key: str, v: float) -> None:
        self._add(key, T_F32, struct.pack("<f", v))

    def add_bool(self, key: str, v: bool) -> None:
        self._add(key, T_BOOL, struct.pack("<B", 1 if v else 0))

    def add_array(self, key: str, values, elem_type: int | None = None) -> None:
        if isinstance(values, np.ndarray) and elem_type is None:
            et = {np.dtype(np.float32): T_F32, np.dtype(np.int32): T_I32,
                  np.dtype(np.uint32): T_U32, np.dtype(np.int64): T_I64}[values.dtype]
            payload = struct.pack("<IQ", et, len(values)) + values.tobytes()
            self._add(key, T_ARR, payload)
            return
        vals = list(values)
        if elem_type is None:
            elem_type = T_STR if (vals and isinstance(vals[0], str)) else _infer_vtype(vals[0]) if vals else T_STR
        body = b"".join(_encode_value(v, elem_type) for v in vals)
        self._add(key, T_ARR, struct.pack("<IQ", elem_type, len(vals)) + body)

    def add_kv(self, key: str, v: Any) -> None:
        if isinstance(v, (list, tuple, np.ndarray)) and not isinstance(v, str):
            self.add_array(key, v)
        else:
            vt = _infer_vtype(v)
            self._add(key, vt, _encode_value(v, vt))

    # -- tensors ---------------------------------------------------------------
    def add_tensor(self, name: str, array: np.ndarray, ggml_type: int | None = None) -> None:
        """Add a tensor. array shape uses numpy convention (last dim contiguous).

        If ggml_type is a quantized type the float array is quantized here.
        """
        arr = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = _NP_TO_GGML[arr.dtype]
        if quants.is_quantized(ggml_type) or ggml_type in (
            quants.GGML_TYPE_F16, quants.GGML_TYPE_F32,
        ) and arr.dtype != np.uint8:
            payload = quants.quantize(arr.astype(np.float32), ggml_type) \
                if ggml_type not in (quants.GGML_TYPE_F32, quants.GGML_TYPE_F16) \
                else (arr.astype(np.float16).view(np.uint8).reshape(-1)
                      if ggml_type == quants.GGML_TYPE_F16
                      else arr.astype(np.float32).view(np.uint8).reshape(-1))
        elif ggml_type == quants.GGML_TYPE_I32:
            payload = arr.astype(np.int32).view(np.uint8).reshape(-1)
        else:
            payload = arr.view(np.uint8).reshape(-1)
        self.tensors.append((name, tuple(arr.shape), ggml_type, bytes(payload)))

    def add_raw_tensor(self, name: str, shape: Tuple[int, ...], ggml_type: int,
                       payload: bytes) -> None:
        """Add pre-quantized raw bytes (used by the requantizer for pass-through)."""
        self.tensors.append((name, tuple(shape), ggml_type, payload))

    # -- output ----------------------------------------------------------------
    def write(self) -> None:
        align = DEFAULT_ALIGNMENT
        out = bytearray()
        out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self.tensors), len(self.kv))
        for key, payload in self.kv:
            out += _encode_str(key) + payload
        offset = 0
        infos = []
        for name, shape, ggml_type, payload in self.tensors:
            infos.append((name, shape, ggml_type, offset, payload))
            offset += (len(payload) + align - 1) // align * align
        for name, shape, ggml_type, toff, _ in infos:
            ne = tuple(reversed(shape))  # gguf stores contiguous dim first
            out += _encode_str(name)
            out += struct.pack("<I", len(ne))
            for d in ne:
                out += struct.pack("<Q", d)
            out += struct.pack("<IQ", ggml_type, toff)
        pad = (-len(out)) % align
        out += b"\x00" * pad
        for name, shape, ggml_type, toff, payload in infos:
            assert len(out) % align == 0 or toff == 0
            out += payload
            out += b"\x00" * ((-len(payload)) % align)
        with open(self.path, "wb") as f:
            f.write(bytes(out))
