"""WAV / AIFF audio file IO (host-side).

Replaces the vendored AudioFile library (reference include/audio_file.h):
encode/decode 16/24/32-bit PCM WAV and AIFF, both to disk and in-memory
(the server returns in-memory encoded audio, server.cpp:712-720).
"""
from __future__ import annotations

import io
import struct

import numpy as np


def _clip(audio: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)


def encode_wav(audio: np.ndarray, sample_rate: int, bit_depth: int = 16) -> bytes:
    """float32 mono waveform in [-1, 1] -> WAV bytes."""
    audio = _clip(audio)
    n = audio.shape[-1]
    if bit_depth == 16:
        data = (audio * 32767.0).astype("<i2").tobytes()
    elif bit_depth == 24:
        i32 = (audio * 8388607.0).astype("<i4")
        b = i32.view(np.uint8).reshape(-1, 4)[:, :3]
        data = b.tobytes()
    elif bit_depth == 32:
        data = audio.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bit_depth}")
    fmt_code = 3 if bit_depth == 32 else 1
    block_align = bit_depth // 8
    byte_rate = sample_rate * block_align
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, fmt_code, 1, sample_rate, byte_rate,
                          block_align, bit_depth))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return buf.getvalue()


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (float32 waveform (channels collapsed to mono), rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = None
    audio = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            audio = body
        pos += 8 + size + (size & 1)
    if fmt is None or audio is None:
        raise ValueError("missing fmt/data chunk")
    code, channels, rate, _, _, bits = fmt
    if code == 3 and bits == 32:
        x = np.frombuffer(audio, "<f4").astype(np.float32)
    elif code == 1 and bits == 16:
        x = np.frombuffer(audio, "<i2").astype(np.float32) / 32767.0
    elif code == 1 and bits == 24:
        raw = np.frombuffer(audio, np.uint8).reshape(-1, 3)
        i32 = np.zeros(raw.shape[0], "<i4")
        b = i32.view(np.uint8).reshape(-1, 4)
        b[:, 1:] = raw  # place in high bytes, arithmetic shift sign-extends
        x = (i32 >> 8).astype(np.float32) / 8388607.0
    elif code == 1 and bits == 32:
        x = np.frombuffer(audio, "<i4").astype(np.float32) / 2147483647.0
    else:
        raise ValueError(f"unsupported wav format code={code} bits={bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def encode_aiff(audio: np.ndarray, sample_rate: int, bit_depth: int = 16) -> bytes:
    """float32 mono waveform -> AIFF bytes (big-endian PCM)."""
    audio = _clip(audio)
    n = audio.shape[-1]
    if bit_depth == 16:
        data = (audio * 32767.0).astype(">i2").tobytes()
    elif bit_depth == 24:
        i32 = (audio * 8388607.0).astype(">i4")
        b = i32.view(np.uint8).reshape(-1, 4)[:, 1:]
        data = b.tobytes()
    elif bit_depth == 32:
        data = (audio * 2147483647.0).astype(">i4").tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bit_depth}")

    # 80-bit IEEE 754 extended float for the sample rate (AIFF COMM chunk)
    def f80(x: float) -> bytes:
        if x == 0:
            return b"\x00" * 10
        import math
        m, e = math.frexp(x)
        e += 16382
        m = int(m * (1 << 64))
        return struct.pack(">H", e) + struct.pack(">Q", m)

    comm = struct.pack(">hIh", 1, n, bit_depth) + f80(float(sample_rate))
    ssnd = struct.pack(">II", 0, 0) + data
    total = 4 + (8 + len(comm)) + (8 + len(ssnd))
    buf = io.BytesIO()
    buf.write(b"FORM")
    buf.write(struct.pack(">I", total))
    buf.write(b"AIFF")
    buf.write(b"COMM")
    buf.write(struct.pack(">I", len(comm)))
    buf.write(comm)
    buf.write(b"SSND")
    buf.write(struct.pack(">I", len(ssnd)))
    buf.write(ssnd)
    return buf.getvalue()


def decode_aiff(data: bytes) -> tuple[np.ndarray, int]:
    """AIFF bytes -> (float32 waveform (channels collapsed to mono), rate).
    Parity: the vendored AudioFile's read path (reference
    include/audio_file.h decodeAiffFile)."""
    if data[:4] != b"FORM" or data[8:12] != b"AIFF":
        raise ValueError("not an AIFF file")
    pos = 12
    comm = None
    audio = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            channels, n_frames, bits = struct.unpack(">hIh", body[:8])
            e = struct.unpack(">H", body[8:10])[0]
            m = struct.unpack(">Q", body[10:18])[0]
            rate = int(round(m / float(1 << 64) * 2.0 ** (e - 16382))) \
                if m else 0
            comm = (channels, n_frames, bits, rate)
        elif cid == b"SSND":
            audio = body[8:]          # skip offset/blockSize
        pos += 8 + size + (size & 1)
    if comm is None or audio is None:
        raise ValueError("missing COMM/SSND chunk")
    channels, _, bits, rate = comm
    if bits == 16:
        x = np.frombuffer(audio, ">i2").astype(np.float32) / 32767.0
    elif bits == 24:
        raw = np.frombuffer(audio, np.uint8).reshape(-1, 3)
        i32 = np.zeros(raw.shape[0], "<i4")
        b = i32.view(np.uint8).reshape(-1, 4)
        b[:, 1:] = raw[:, ::-1]   # big-endian bytes into high little-endian
        x = (i32 >> 8).astype(np.float32) / 8388607.0
    elif bits == 32:
        x = np.frombuffer(audio, ">i4").astype(np.float32) / 2147483647.0
    else:
        raise ValueError(f"unsupported aiff bit depth {bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def read_audio_file(path: str) -> tuple[np.ndarray, int]:
    """Load a WAV or AIFF file -> (float32 mono waveform, sample rate).
    Format sniffed from the header, like the reference's AudioFile::load."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"FORM":
        return decode_aiff(data)
    return decode_wav(data)


def write_audio_file(audio: np.ndarray, path: str, sample_rate: int,
                     bit_depth: int = 16) -> None:
    """Parity: reference write_audio_file (examples/cli/write_file.cpp)."""
    if path.lower().endswith((".aiff", ".aif")):
        data = encode_aiff(audio, sample_rate, bit_depth)
    else:
        data = encode_wav(audio, sample_rate, bit_depth)
    with open(path, "wb") as f:
        f.write(data)
