"""Minimal OpenEXR scanline reader and writer in numpy (the port's copy of
``robir_tpu/utils/exr.py``; files written by either package read in the
other).

The subset of OpenEXR 2.0 that the pipeline's files need (ground-truth
envmaps, HDR dataset images, the texture caches of
``texture/pipeline.py``):

- single-part scanline images,
- NO_COMPRESSION / ZIPS / ZIP (zlib + EXR byte predictor) and PIZ
  (wavelet + Huffman, through the port's native codec,
  ``texture/native.py``),
- HALF / FLOAT / UINT channels, increasing-Y line order.

The writer emits ZIP-compressed FLOAT RGB(A) by default, or PIZ-compressed
HALF with ``compression="piz"``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..texture.native import _load

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.dtype("<u4"), _PT_HALF: np.dtype("<f2"), _PT_FLOAT: np.dtype("<f4")}
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP, _PIZ = 0, 1, 2, 3, 4
_LINES_PER_CHUNK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32}


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def _parse_channels(val: bytes) -> list[tuple[str, int]]:
    chans = []
    off = 0
    while val[off] != 0:
        name, off = _read_cstr(val, off)
        ptype, xs, ys = struct.unpack_from("<i4xii", val, off)
        if xs != 1 or ys != 1:
            raise NotImplementedError("subsampled channels not supported")
        off += 16
        chans.append((name, ptype))
    return chans


def _predictor_decode(data: bytearray) -> bytes:
    # delta-decode: d[i] = d[i-1] + d[i] - 128 (first byte kept as-is)
    raw = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32)
    out = np.zeros_like(raw)
    out[0] = raw[0]
    out[1:] = np.cumsum(raw[1:] - 128) + raw[0]
    out &= 0xFF
    # de-interleave: first half -> even indices, second half -> odd
    n = len(out)
    half = (n + 1) // 2
    res = np.empty(n, dtype=np.uint8)
    res[0::2] = out[:half]
    res[1::2] = out[half:]
    return res.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, dtype=np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    x = inter.astype(np.int32)
    d = np.empty(n, dtype=np.int32)
    d[0] = x[0]
    d[1:] = x[1:] - x[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _piz_uncompress(data: bytes, n_channels: int, width: int,
                    rows: int) -> np.ndarray:
    """Decode one PIZ chunk through the native decoder -> u16 planar
    [n_channels, rows, width] (HALF bit patterns)."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((n_channels, rows, width), np.uint16)
    rc = lib.piz_uncompress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
        n_channels, width, rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"PIZ decode failed rc={rc}")
    return out


def _piz_compress(planar_u16: np.ndarray) -> bytes:
    """Encode one PIZ chunk from u16 planar [n_channels, rows, width]
    (HALF bit patterns) through the native encoder."""
    lib = _load()
    c, rows, width = planar_u16.shape
    src = np.ascontiguousarray(planar_u16).ravel()
    outp = ctypes.c_void_p()
    sz = lib.piz_compress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        c, width, rows, ctypes.byref(outp))
    if sz <= 0:
        raise ValueError(f"PIZ encode failed rc={sz}")
    out = ctypes.string_at(outp.value, sz)
    lib.free_buffer(outp)
    return out


def read_exr(path: str) -> np.ndarray:
    """Read an EXR image as float32 [H, W, C]. Channels ordered R, G, B(, A)
    when present, otherwise alphabetically."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    off = 8
    attrs: dict[str, bytes] = {}
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        _typ, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = buf[off:off + size]
        off += size

    chans = _parse_channels(attrs["channels"])  # alphabetically sorted in file
    compression = attrs["compression"][0]
    if compression not in _LINES_PER_CHUNK:
        raise NotImplementedError(f"EXR compression {compression} not supported")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk

    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, off)

    per_line = sum(_PT_DTYPE[pt].itemsize for _, pt in chans) * W
    out = {name: np.zeros((H, W), np.float32) for name, _ in chans}

    for ofs in offsets:
        y, packed = struct.unpack_from("<ii", buf, ofs)
        data = buf[ofs + 8: ofs + 8 + packed]
        rows = min(lines_per_chunk, y1 - y + 1)
        raw_size = per_line * rows
        row0 = y - y0
        if compression == _PIZ and packed < raw_size:
            if any(pt != _PT_HALF for _, pt in chans):
                raise NotImplementedError("PIZ with non-HALF channels")
            planar = _piz_uncompress(data, len(chans), W, rows)
            for ci, (name, _pt) in enumerate(chans):
                halves = planar[ci].view("<f2")
                out[name][row0:row0 + rows] = halves.astype(np.float32)
            continue
        if compression in (_ZIP, _ZIPS) and packed < raw_size:
            data = zlib.decompress(data)
            data = _predictor_decode(bytearray(data))
        pos = 0
        for r in range(rows):
            for name, pt in chans:
                dt = _PT_DTYPE[pt]
                nb = dt.itemsize * W
                line = np.frombuffer(data, dtype=dt, count=W, offset=pos)
                out[name][row0 + r] = line.astype(np.float32)
                pos += nb

    names = [n for n, _ in chans]
    order = [n for n in ("R", "G", "B", "A") if n in names] or sorted(names)
    return np.stack([out[n] for n in order], axis=-1)


def write_exr(path: str, img: np.ndarray, compression: str = "zip") -> None:
    """Write float32 [H, W, C] (C in {1,3,4}) as an EXR.

    ``compression``: "zip" (FLOAT channels, zlib + predictor, 16-line
    chunks), "piz" (HALF channels, wavelet + Huffman via the native codec,
    32-line chunks — OpenEXR's default for film assets), or "none"
    (FLOAT, uncompressed).
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[C]
    chan_order = sorted(names)  # EXR stores channels alphabetically
    comp_id = {"zip": _ZIP, "piz": _PIZ, "none": _NO_COMPRESSION}[compression]
    ptype = _PT_HALF if comp_id == _PIZ else _PT_FLOAT
    lines = _LINES_PER_CHUNK[comp_id]

    def attr(name: str, typ: str, val: bytes) -> bytes:
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(val)) + val

    chlist = b""
    for n in chan_order:
        chlist += n.encode() + b"\x00" + struct.pack("<i4xii", ptype, 1, 1)
    chlist += b"\x00"

    header = struct.pack("<iI", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([comp_id]))
    header += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    by_name = {n: img[..., i] for i, n in enumerate(names)}
    n_chunks = (H + lines - 1) // lines
    chunks = []
    for ci in range(n_chunks):
        r0, r1 = ci * lines, min(ci * lines + lines, H)
        if comp_id == _PIZ:
            planar = np.stack([by_name[n][r0:r1].astype("<f2").view(np.uint16)
                               for n in chan_order])
            raw = b"".join(by_name[n][r].astype("<f2").tobytes()
                           for r in range(r0, r1) for n in chan_order)
            comp = _piz_compress(planar)
            if len(comp) >= len(raw):  # incompressible chunk -> stored raw
                comp = raw
        else:
            raw = b"".join(
                by_name[n][r].astype("<f4").tobytes()
                for r in range(r0, r1)
                for n in chan_order
            )
            if comp_id == _ZIP:
                comp = zlib.compress(_predictor_encode(raw))
                if len(comp) >= len(raw):
                    comp = raw
            else:
                comp = raw
        chunks.append((r0, comp))

    table_off = len(header) + 8 * n_chunks
    offsets, pos = [], table_off
    for r0, comp in chunks:
        offsets.append(pos)
        pos += 8 + len(comp)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for r0, comp in chunks:
            f.write(struct.pack("<ii", r0, len(comp)))
            f.write(comp)
