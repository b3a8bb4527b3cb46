"""GeoTIFF read/write in numpy and zlib (no GDAL).

The port's own copy of ``geo_deep_learning_tpu/data/geotiff.py``, reduced
to what the port's data and predict paths use. Pixels are decoded by the
native libtiff reader (``data/_native.py``) where it is built, as in the
JAX package; the numpy codec below decodes them elsewhere, and the geo
tags always come from the tag parser here.

Reading: classic TIFF and BigTIFF, both byte orders; striped and tiled
layouts; chunky and separate planes; 8/16/32-bit integer and 32/64-bit
float samples; no compression, Deflate, LZW or PackBits, with the
horizontal-differencing predictor; geo tags (pixel scale + tiepoint or the
model transformation), the EPSG code and GDAL nodata.

Writing: striped, chunky, little-endian classic TIFF, uncompressed or
Deflate, without geo tags (``data/geotiff_stream.py`` writes georeferenced
rasters strip by strip, with LZW too).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from geo_deep_learning_tpu_torch.data._native import read_pixels_native

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_BITS = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SPP = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_COUNTS = 279
TAG_PLANAR = 284
TAG_PREDICTOR = 317
TAG_EXTRA_SAMPLES = 338
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORM = 34264
TAG_GEO_KEYS = 34735
TAG_GDAL_NODATA = 42113

COMP_NONE = 1
COMP_LZW = 5
COMP_DEFLATE_ADOBE = 8
COMP_PACKBITS = 32773
COMP_DEFLATE = 32946

GEOKEY_GT_MODEL_TYPE = 1024
GEOKEY_GEOGRAPHIC_CS = 2048
GEOKEY_PROJECTED_CS = 3072


@dataclass
class Affine:
    """Row-major 2-D affine, rasterio's ``Affine(a, b, c, d, e, f)`` order."""

    a: float = 1.0
    b: float = 0.0
    c: float = 0.0
    d: float = 0.0
    e: float = -1.0
    f: float = 0.0

    def invert(self) -> Affine:
        det = self.a * self.e - self.b * self.d
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)


@dataclass
class GeoInfo:
    transform: Affine = field(default_factory=Affine)
    epsg: int | None = None
    nodata: float | None = None


class _TiffFile:
    def __init__(self, data: bytes):
        self.data = data
        if data[:2] == b"II":
            self.bo = "<"
        elif data[:2] == b"MM":
            self.bo = ">"
        else:
            msg = "not a TIFF file"
            raise ValueError(msg)
        magic = struct.unpack(self.bo + "H", data[2:4])[0]
        if magic not in (42, 43):
            msg = f"bad TIFF magic {magic}"
            raise ValueError(msg)
        self.big = magic == 43
        if self.big:
            self.first_ifd = struct.unpack(self.bo + "Q", data[8:16])[0]
        else:
            self.first_ifd = struct.unpack(self.bo + "I", data[4:8])[0]

    def read_ifd(self, offset: int) -> dict[int, list]:
        bo, data = self.bo, self.data
        if self.big:
            count = struct.unpack(bo + "Q", data[offset : offset + 8])[0]
            entry_size, base = 20, offset + 8
        else:
            count = struct.unpack(bo + "H", data[offset : offset + 2])[0]
            entry_size, base = 12, offset + 2
        tags: dict[int, list] = {}
        for i in range(count):
            e = base + i * entry_size
            tag, typ = struct.unpack(bo + "HH", data[e : e + 4])
            if self.big:
                n = struct.unpack(bo + "Q", data[e + 4 : e + 12])[0]
                value_field = data[e + 12 : e + 20]
            else:
                n = struct.unpack(bo + "I", data[e + 4 : e + 8])[0]
                value_field = data[e + 8 : e + 12]
            size = _TYPE_SIZES.get(typ, 1) * n
            if size <= len(value_field):
                raw = value_field[:size]
            else:
                off = struct.unpack(bo + ("Q" if self.big else "I"), value_field)[0]
                raw = data[off : off + size]
            tags[tag] = self._decode_values(typ, n, raw)
        return tags

    def _decode_values(self, typ: int, n: int, raw: bytes) -> list:
        if typ == 2:
            return [raw.rstrip(b"\0").decode("ascii", "replace")]
        if typ in (5, 10):
            fmt = "I" if typ == 5 else "i"
            vals = struct.unpack(self.bo + fmt * (2 * n), raw)
            return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(n)]
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            return [raw]
        return list(struct.unpack(self.bo + fmt * n, raw))


def _dtype_from_tags(bits: int, sample_format: int) -> np.dtype:
    if sample_format == 3:
        return {32: np.float32, 64: np.float64}[bits]
    if sample_format == 2:
        return {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    return {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first, early change)."""
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos = 0
    nbits = 9
    prev: bytes | None = None
    total_bits = len(data) * 8
    while True:
        if bitpos + nbits > total_bits:
            break
        byte_idx = bitpos // 8
        chunk = int.from_bytes(data[byte_idx : byte_idx + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos % 8) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            nbits = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW encode (MSB-first, early change), the dual of
    :func:`_lzw_decode`."""
    clear, eoi = 256, 257
    out = bytearray()
    acc = 0  # bit accumulator
    acc_bits = 0

    def emit(code: int, nbits: int) -> None:
        nonlocal acc, acc_bits
        acc = (acc << nbits) | code
        acc_bits += nbits
        while acc_bits >= 8:
            acc_bits -= 8
            out.append((acc >> acc_bits) & 0xFF)
        acc &= (1 << acc_bits) - 1

    # strings are (prefix code, next byte) chains
    table: dict[tuple[int, int], int] = {}
    next_code = 258
    nbits = 9
    emit(clear, nbits)
    it = iter(data)
    w = next(it, None)
    if w is not None:
        for byte in it:
            code = table.get((w, byte))
            if code is not None:
                w = code
                continue
            emit(w, nbits)
            if next_code >= 4093:  # table nearly full: reset, as the decoder does on clear
                emit(clear, nbits)
                table.clear()
                next_code = 258
                nbits = 9
            else:
                table[(w, byte)] = next_code
                next_code += 1
                # early change: the decoder's table lags the encoder's by
                # one entry and widens at (1 << nbits) - 1
                if next_code >= (1 << nbits) and nbits < 12:
                    nbits += 1
            w = byte
        emit(w, nbits)
    emit(eoi, nbits)
    if acc_bits:
        out.append((acc << (8 - acc_bits)) & 0xFF)
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, compression: int) -> bytes:
    if compression == COMP_NONE:
        return raw
    if compression in (COMP_DEFLATE, COMP_DEFLATE_ADOBE):
        return zlib.decompress(raw)
    if compression == COMP_LZW:
        return _lzw_decode(raw)
    if compression == COMP_PACKBITS:
        return _packbits_decode(raw)
    msg = f"unsupported TIFF compression {compression}"
    raise ValueError(msg)


def _undo_predictor(block: np.ndarray) -> np.ndarray:
    """Predictor 2: horizontal differencing along the row axis."""
    return np.cumsum(block, axis=1, dtype=block.dtype)


_GEO_TAGS = frozenset({TAG_MODEL_PIXEL_SCALE, TAG_MODEL_TIEPOINT, TAG_MODEL_TRANSFORM,
                       TAG_GEO_KEYS, TAG_GDAL_NODATA})


def read_geo_only(path: str | Path) -> GeoInfo:
    """The geo tags of the first IFD, read with targeted seeks (no pixel
    payload passes through Python)."""
    with Path(path).open("rb") as f:
        head = f.read(16)
        tf = _TiffFile.__new__(_TiffFile)
        tf.bo = {b"II": "<", b"MM": ">"}.get(head[:2])
        if tf.bo is None:
            msg = "not a TIFF file"
            raise ValueError(msg)
        tf.big = struct.unpack(tf.bo + "H", head[2:4])[0] == 43
        offset_fmt = tf.bo + ("Q" if tf.big else "I")
        f.seek(struct.unpack(offset_fmt, head[8:16] if tf.big else head[4:8])[0])
        count_size, entry_size = (8, 20) if tf.big else (2, 12)
        count = struct.unpack(tf.bo + ("Q" if tf.big else "H"), f.read(count_size))[0]
        entries = f.read(count * entry_size)
        tags: dict[int, list] = {}
        for i in range(count):
            e = entries[i * entry_size : (i + 1) * entry_size]
            tag, typ = struct.unpack(tf.bo + "HH", e[:4])
            if tag not in _GEO_TAGS:
                continue
            n_field, value_field = (e[4:12], e[12:20]) if tf.big else (e[4:8], e[8:12])
            n = struct.unpack(offset_fmt, n_field)[0]
            size = _TYPE_SIZES.get(typ, 1) * n
            if size <= len(value_field):
                raw = value_field[:size]
            else:
                f.seek(struct.unpack(offset_fmt, value_field)[0])
                raw = f.read(size)
            tags[tag] = tf._decode_values(typ, n, raw)
    return _parse_geo(tags)


def read_geotiff(path: str | Path) -> tuple[np.ndarray, GeoInfo]:
    """Read a GeoTIFF into an HWC array (single band: trailing axis of 1):
    the native libtiff reader first, as the JAX package's ``read_geotiff``,
    else the numpy codec."""
    native = read_pixels_native(path)
    if native is not None:
        return native, read_geo_only(path)
    return read_geotiff_numpy(path)


def read_geotiff_numpy(path: str | Path) -> tuple[np.ndarray, GeoInfo]:
    """:func:`read_geotiff` through the numpy codec alone."""
    data = Path(path).read_bytes()
    tf = _TiffFile(data)
    tags = tf.read_ifd(tf.first_ifd)
    width = int(tags[TAG_WIDTH][0])
    height = int(tags[TAG_HEIGHT][0])
    spp = int(tags.get(TAG_SPP, [1])[0])
    bits_list = tags.get(TAG_BITS, [8])
    bits = int(bits_list[0])
    if any(int(b) != bits for b in bits_list):
        msg = "mixed per-band bit depths unsupported"
        raise ValueError(msg)
    dtype = _dtype_from_tags(bits, int(tags.get(TAG_SAMPLE_FORMAT, [1])[0]))
    dt = np.dtype(dtype).newbyteorder(tf.bo)
    compression = int(tags.get(TAG_COMPRESSION, [COMP_NONE])[0])
    predictor = int(tags.get(TAG_PREDICTOR, [1])[0])
    planar = int(tags.get(TAG_PLANAR, [1])[0])
    planes = spp if planar == 2 else 1
    chans = 1 if planar == 2 else spp

    tiled = TAG_TILE_OFFSETS in tags
    if tiled:
        bw = int(tags[TAG_TILE_WIDTH][0])
        bh = int(tags[TAG_TILE_LENGTH][0])
        offsets, counts = tags[TAG_TILE_OFFSETS], tags[TAG_TILE_COUNTS]
        across = -(-width // bw)
    else:
        bw = width
        bh = int(tags.get(TAG_ROWS_PER_STRIP, [height])[0])
        offsets, counts = tags[TAG_STRIP_OFFSETS], tags[TAG_STRIP_COUNTS]
        across = 1
    down = -(-height // bh)

    img = np.zeros((height, width, spp), dtype=dtype)
    idx = 0
    for plane in range(planes):
        for by in range(down):
            for bx in range(across):
                raw = _decompress(
                    data[offsets[idx] : offsets[idx] + counts[idx]], compression
                )
                idx += 1
                y0, x0 = by * bh, bx * bw
                rows = bh if tiled else min(bh, height - y0)
                block = np.frombuffer(raw, dtype=dt, count=rows * bw * chans)
                block = block.reshape(rows, bw, chans)
                if predictor == 2:
                    block = _undo_predictor(block)
                ys, xs = min(rows, height - y0), min(bw, width - x0)
                sel = slice(plane, plane + 1) if planar == 2 else slice(None)
                img[y0 : y0 + ys, x0 : x0 + xs, sel] = block[:ys, :xs]
    return img, _parse_geo(tags)


def _parse_geo(tags: dict) -> GeoInfo:
    geo = GeoInfo()
    if TAG_MODEL_TRANSFORM in tags:
        m = tags[TAG_MODEL_TRANSFORM]
        geo.transform = Affine(m[0], m[1], m[3], m[4], m[5], m[7])
    elif TAG_MODEL_PIXEL_SCALE in tags and TAG_MODEL_TIEPOINT in tags:
        sx, sy = tags[TAG_MODEL_PIXEL_SCALE][:2]
        i, j, _, x, y, _ = tags[TAG_MODEL_TIEPOINT][:6]
        geo.transform = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
    if TAG_GEO_KEYS in tags:
        keys = tags[TAG_GEO_KEYS]
        for k in range(4, len(keys), 4):
            key_id, tag_loc, _count, value = keys[k : k + 4]
            if key_id in (GEOKEY_PROJECTED_CS, GEOKEY_GEOGRAPHIC_CS) and tag_loc == 0:
                geo.epsg = int(value)
    if TAG_GDAL_NODATA in tags:
        try:
            geo.nodata = float(str(tags[TAG_GDAL_NODATA][0]).strip())
        except ValueError:
            pass
    return geo


def write_geotiff(
    path: str | Path,
    array: np.ndarray,
    compress: str | None = "deflate",
    rows_per_strip: int = 64,
) -> None:
    """Write an HWC (or HW) array as a striped little-endian classic TIFF
    (no geo tags: the patches' predictions carry none, as in the JAX
    package's ``predict``)."""
    if array.ndim == 2:
        array = array[..., None]
    height, width, spp = array.shape
    dtype = array.dtype
    sample_format = {"f": 3, "i": 2, "u": 1}.get(dtype.kind)
    if sample_format is None:
        msg = f"unsupported dtype {dtype}"
        raise ValueError(msg)
    bits = dtype.itemsize * 8
    comp = {None: COMP_NONE, "none": COMP_NONE, "deflate": COMP_DEFLATE_ADOBE}[compress]
    strips = []
    for y0 in range(0, height, rows_per_strip):
        block = np.ascontiguousarray(
            array[y0 : y0 + rows_per_strip], dtype=dtype.newbyteorder("<")
        ).tobytes()
        if comp == COMP_DEFLATE_ADOBE:
            block = zlib.compress(block, 6)
        strips.append(block)
    if sum(len(s) for s in strips) + 65536 > 2**32 - 1:
        msg = "raster too large for a classic TIFF"
        raise ValueError(msg)

    entries: list[tuple[int, int, list]] = [
        (TAG_WIDTH, 4, [width]),
        (TAG_HEIGHT, 4, [height]),
        (TAG_BITS, 3, [bits] * spp),
        (TAG_COMPRESSION, 3, [comp]),
        (TAG_PHOTOMETRIC, 3, [2 if (spp == 3 and bits == 8) else 1]),
        (TAG_SPP, 3, [spp]),
        (TAG_ROWS_PER_STRIP, 3, [rows_per_strip]),
        (TAG_PLANAR, 3, [1]),
        (TAG_SAMPLE_FORMAT, 3, [sample_format] * spp),
    ]
    entries.append((TAG_STRIP_OFFSETS, 4, [0] * len(strips)))  # patched below
    entries.append((TAG_STRIP_COUNTS, 4, [len(s) for s in strips]))
    entries.sort(key=lambda e: e[0])

    def encode_values(typ: int, vals: list) -> bytes:
        if typ == 2:
            return b"".join(v.encode("ascii") for v in vals)
        return struct.pack("<" + _TYPE_FMT[typ] * len(vals), *vals)

    # layout: 8-byte header | IFD | values longer than 4 bytes | strips
    ifd_size = 2 + len(entries) * 12 + 4
    overflow_offset = 8 + ifd_size
    overflow_size = sum(
        len(encode_values(typ, vals)) for _, typ, vals in entries
        if len(encode_values(typ, vals)) > 4
    )
    pos = overflow_offset + overflow_size
    strip_offsets = []
    for s in strips:
        strip_offsets.append(pos)
        pos += len(s)
    entries = [
        (tag, typ, strip_offsets if tag == TAG_STRIP_OFFSETS else vals)
        for tag, typ, vals in entries
    ]
    out = bytearray(b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", len(entries)))
    overflow = bytearray()
    for tag, typ, vals in entries:
        enc = encode_values(typ, vals)
        count = len(vals) if typ != 2 else len(enc)
        out += struct.pack("<HHI", tag, typ, count)
        if len(enc) <= 4:
            out += enc.ljust(4, b"\0")
        else:
            out += struct.pack("<I", overflow_offset + len(overflow))
            overflow += enc
    out += struct.pack("<I", 0)
    out += overflow
    for s in strips:
        out += s
    Path(path).write_bytes(bytes(out))
