"""Streaming GeoTIFF I/O: windowed reads and incremental strip writes.

Port of ``geo_deep_learning_tpu/data/geotiff_stream.py``, for scenes too
large to decode whole. :class:`GeoTiffWindowReader` maps the file and
decodes only the strips or tiles that a requested row window touches;
:class:`GeoTiffStripWriter` takes rows as they come, writes each strip as it
fills and the IFD last (the header's IFD pointer is patched at close), so it
holds one strip at a time. Both use the port's own codec in
``data/geotiff.py``.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from pathlib import Path

import numpy as np

from geo_deep_learning_tpu_torch.data.geotiff import (
    _TYPE_FMT,
    COMP_DEFLATE_ADOBE,
    COMP_LZW,
    COMP_NONE,
    GEOKEY_GEOGRAPHIC_CS,
    GEOKEY_GT_MODEL_TYPE,
    GEOKEY_PROJECTED_CS,
    TAG_BITS,
    TAG_COMPRESSION,
    TAG_EXTRA_SAMPLES,
    TAG_GDAL_NODATA,
    TAG_GEO_KEYS,
    TAG_HEIGHT,
    TAG_MODEL_PIXEL_SCALE,
    TAG_MODEL_TIEPOINT,
    TAG_PHOTOMETRIC,
    TAG_PLANAR,
    TAG_PREDICTOR,
    TAG_ROWS_PER_STRIP,
    TAG_SAMPLE_FORMAT,
    TAG_SPP,
    TAG_STRIP_COUNTS,
    TAG_STRIP_OFFSETS,
    TAG_TILE_COUNTS,
    TAG_TILE_LENGTH,
    TAG_TILE_OFFSETS,
    TAG_TILE_WIDTH,
    TAG_WIDTH,
    GeoInfo,
    _decompress,
    _dtype_from_tags,
    _lzw_encode,
    _parse_geo,
    _TiffFile,
    _undo_predictor,
)


class GeoTiffWindowReader:
    """Row-window access to a GeoTIFF of any size: striped or tiled, none /
    LZW / Deflate / PackBits, the horizontal predictor, chunky or planar
    bands. ``height``, ``width``, ``channels``, ``dtype`` and ``geo``
    describe the raster."""

    def __init__(self, path: str | Path) -> None:
        self._file = open(path, "rb")  # noqa: SIM115 - lives as long as the reader
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        tf = _TiffFile(self._mm)
        tags = tf.read_ifd(tf.first_ifd)
        self.width = int(tags[TAG_WIDTH][0])
        self.height = int(tags[TAG_HEIGHT][0])
        self.channels = int(tags.get(TAG_SPP, [1])[0])
        bits = int(tags.get(TAG_BITS, [8])[0])
        self.dtype = np.dtype(_dtype_from_tags(bits, int(tags.get(TAG_SAMPLE_FORMAT, [1])[0])))
        self._dt = self.dtype.newbyteorder(tf.bo)
        self._compression = int(tags.get(TAG_COMPRESSION, [COMP_NONE])[0])
        self._predictor = int(tags.get(TAG_PREDICTOR, [1])[0])
        self._planar = int(tags.get(TAG_PLANAR, [1])[0])
        self.geo: GeoInfo = _parse_geo(tags)
        self._tiled = TAG_TILE_OFFSETS in tags
        if self._tiled:
            self._tw = int(tags[TAG_TILE_WIDTH][0])
            self._th = int(tags[TAG_TILE_LENGTH][0])
            self._offsets, self._counts = tags[TAG_TILE_OFFSETS], tags[TAG_TILE_COUNTS]
            self._tiles_across = -(-self.width // self._tw)
            self._tiles_down = -(-self.height // self._th)
        else:
            self._offsets, self._counts = tags[TAG_STRIP_OFFSETS], tags[TAG_STRIP_COUNTS]
            self._rps = int(tags.get(TAG_ROWS_PER_STRIP, [self.height])[0])
            self._strips_per_plane = -(-self.height // self._rps)

    def read_rows(self, row0: int, nrows: int) -> np.ndarray:
        """Decode rows ``[row0, row0 + nrows)`` (clamped to the raster) ->
        ``[nrows, W, C]``."""
        row0 = max(0, row0)
        nrows = min(nrows, self.height - row0)
        out = np.zeros((nrows, self.width, self.channels), self.dtype)
        planes = self.channels if self._planar == 2 else 1
        chans = 1 if self._planar == 2 else self.channels
        for plane in range(planes):
            if self._tiled:
                for ty in range(row0 // self._th, (row0 + nrows - 1) // self._th + 1):
                    for tx in range(self._tiles_across):
                        idx = (plane * self._tiles_down + ty) * self._tiles_across + tx
                        block = self._decode(idx, self._th, self._tw, chans)
                        self._paste(out, block, ty * self._th, tx * self._tw, row0, plane)
            else:
                for s in range(row0 // self._rps, (row0 + nrows - 1) // self._rps + 1):
                    y0 = s * self._rps
                    rows = min(self._rps, self.height - y0)
                    block = self._decode(plane * self._strips_per_plane + s, rows, self.width, chans)
                    self._paste(out, block, y0, 0, row0, plane)
        return out

    def _decode(self, idx: int, rows: int, cols: int, chans: int) -> np.ndarray:
        off, n = self._offsets[idx], self._counts[idx]
        raw = _decompress(self._mm[off : off + n], self._compression)
        block = np.frombuffer(raw, dtype=self._dt, count=rows * cols * chans)
        block = block.reshape(rows, cols, chans)
        return _undo_predictor(block) if self._predictor == 2 else block

    def _paste(self, out, block, by0, bx0, row0, plane) -> None:
        src0, dst0 = max(0, row0 - by0), max(0, by0 - row0)
        rows = min(block.shape[0] - src0, out.shape[0] - dst0)
        if rows <= 0:
            return
        cols = min(block.shape[1], self.width - bx0)
        view = block[src0 : src0 + rows, :cols]
        if self._planar == 2:
            out[dst0 : dst0 + rows, bx0 : bx0 + cols, plane] = view[..., 0]
        else:
            out[dst0 : dst0 + rows, bx0 : bx0 + cols, :] = view

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GeoTiffStripWriter:
    """Striped little-endian GeoTIFF (BigTIFF by default) written as rows
    arrive: ``write_rows`` flushes every full strip, ``close`` the last
    partial one, then the IFD with the geo tags (pixel scale + tiepoint,
    the EPSG code, GDAL nodata)."""

    def __init__(
        self,
        path: str | Path,
        width: int,
        channels: int,
        dtype,
        geo: GeoInfo | None = None,
        compress: str | None = "deflate",
        rows_per_strip: int = 64,
        bigtiff: bool = True,
    ) -> None:
        self.width = width
        self.channels = channels
        self.dtype = np.dtype(dtype)
        self.geo = geo
        self.rows_per_strip = rows_per_strip
        self.bigtiff = bigtiff
        self._comp = {None: COMP_NONE, "none": COMP_NONE, "deflate": COMP_DEFLATE_ADOBE,
                      "lzw": COMP_LZW}[compress]
        self._f = open(path, "wb")  # noqa: SIM115 - lives as long as the writer
        header = 16 if bigtiff else 8
        self._f.write(b"\0" * header)  # patched in close()
        self._pos = header
        self._strip_offsets: list[int] = []
        self._strip_counts: list[int] = []
        self._buf = np.zeros((0, width, channels), self.dtype)
        self._rows_written = 0

    def write_rows(self, rows: np.ndarray) -> None:
        if rows.ndim == 2:
            rows = rows[..., None]
        if rows.shape[1] != self.width or rows.shape[2] != self.channels:
            msg = f"row block {rows.shape} does not match {self.width}x{self.channels}"
            raise ValueError(msg)
        self._buf = np.concatenate([self._buf, rows.astype(self.dtype)])
        while self._buf.shape[0] >= self.rows_per_strip:
            self._flush_strip(self._buf[: self.rows_per_strip])
            self._buf = self._buf[self.rows_per_strip :]

    def _flush_strip(self, block: np.ndarray) -> None:
        raw = np.ascontiguousarray(block, dtype=self.dtype.newbyteorder("<")).tobytes()
        if self._comp == COMP_DEFLATE_ADOBE:
            raw = zlib.compress(raw, 6)
        elif self._comp == COMP_LZW:
            raw = _lzw_encode(raw)
        self._strip_offsets.append(self._pos)
        self._strip_counts.append(len(raw))
        self._f.write(raw)
        self._pos += len(raw)
        self._rows_written += block.shape[0]

    def _entries(self) -> list[tuple[int, int, list]]:
        spp, bits = self.channels, self.dtype.itemsize * 8
        sample_format = {"f": 3, "i": 2}.get(self.dtype.kind, 1)
        offsets = 16 if self.bigtiff else 4  # LONG8 or LONG
        entries = [
            (TAG_WIDTH, 4, [self.width]),
            (TAG_HEIGHT, 4, [self._rows_written]),
            (TAG_BITS, 3, [bits] * spp),
            (TAG_COMPRESSION, 3, [self._comp]),
            (TAG_PHOTOMETRIC, 3, [2 if (spp == 3 and bits == 8) else 1]),
            (TAG_SPP, 3, [spp]),
            (TAG_ROWS_PER_STRIP, 3, [self.rows_per_strip]),
            (TAG_PLANAR, 3, [1]),
            (TAG_SAMPLE_FORMAT, 3, [sample_format] * spp),
            (TAG_STRIP_OFFSETS, offsets, self._strip_offsets),
            (TAG_STRIP_COUNTS, offsets, self._strip_counts),
        ]
        if spp > 3:
            entries.append((TAG_EXTRA_SAMPLES, 3, [0] * (spp - 3)))
        geo = self.geo
        if geo is not None:
            t = geo.transform
            entries.append((TAG_MODEL_PIXEL_SCALE, 12, [abs(t.a), abs(t.e), 0.0]))
            entries.append((TAG_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, t.c, t.f, 0.0]))
            if geo.epsg is not None:
                geographic = geo.epsg == 4326
                cs_key = GEOKEY_GEOGRAPHIC_CS if geographic else GEOKEY_PROJECTED_CS
                entries.append((TAG_GEO_KEYS, 3, [1, 1, 0, 2,
                                                  GEOKEY_GT_MODEL_TYPE, 0, 1, 2 if geographic else 1,
                                                  cs_key, 0, 1, int(geo.epsg)]))
            if geo.nodata is not None:
                entries.append((TAG_GDAL_NODATA, 2, [f"{geo.nodata:g}\0"]))
        return sorted(entries, key=lambda e: e[0])

    def close(self) -> None:
        if self._buf.shape[0]:
            self._flush_strip(self._buf)
            self._buf = self._buf[:0]
        entries = self._entries()
        inline = 8 if self.bigtiff else 4
        entry_size = 20 if self.bigtiff else 12
        count_fmt = "<Q" if self.bigtiff else "<I"
        ifd_offset = self._pos
        ifd_size = (16 if self.bigtiff else 6) + len(entries) * entry_size

        def encode_values(typ: int, vals: list) -> bytes:
            if typ == 2:
                return b"".join(v.encode("ascii") for v in vals)
            return struct.pack("<" + _TYPE_FMT[typ] * len(vals), *vals)

        # entry count: u16 in classic TIFF, u64 in BigTIFF
        ifd = bytearray(struct.pack("<Q" if self.bigtiff else "<H", len(entries)))
        overflow = bytearray()
        for tag, typ, vals in entries:
            enc = encode_values(typ, vals)
            count = len(vals) if typ != 2 else len(enc)
            ifd += struct.pack("<HH", tag, typ) + struct.pack(count_fmt, count)
            if len(enc) <= inline:
                ifd += enc.ljust(inline, b"\0")
            else:
                ifd += struct.pack(count_fmt, ifd_offset + ifd_size + len(overflow))
                overflow += enc
        ifd += struct.pack(count_fmt, 0)  # no next IFD
        self._f.write(bytes(ifd) + bytes(overflow))
        self._f.seek(0)
        if self.bigtiff:
            self._f.write(b"II" + struct.pack("<HHH", 43, 8, 0) + struct.pack("<Q", ifd_offset))
        else:
            self._f.write(b"II*\0" + struct.pack("<I", ifd_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
