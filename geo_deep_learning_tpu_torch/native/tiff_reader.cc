// Native GeoTIFF pixel decoder (libtiff) — the hot path of the training
// input pipeline.
//
// The reference delegates raster decode to rasterio/GDAL (C); the port's
// numpy codec (data/geotiff.py) is what runs where libtiff's header is
// absent, but Python-side inflate/strip assembly costs real milliseconds
// per 512x512 patch. This library decodes strip- or tile-organized TIFFs
// of any libtiff-supported compression straight into a caller-provided
// HWC-interleaved buffer. Geo metadata stays in Python (tag parsing is
// cheap; only pixel decode is hot).
//
// C ABI (ctypes-friendly):
//   gdl_tiff_read_info(path, &w, &h, &spp, &dtype_code) -> 0 | errcode
//   gdl_tiff_read(path, out_buffer)                     -> 0 | errcode
// dtype codes: 1=u8 2=u16 3=u32 4=i8 5=i16 6=i32 7=f32 8=f64

#include <tiffio.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrOpen = 1;
constexpr int kErrRead = 2;
constexpr int kErrUnsupported = 3;

int dtype_code(uint16_t bits, uint16_t fmt) {
  if (fmt == SAMPLEFORMAT_IEEEFP) return bits == 32 ? 7 : (bits == 64 ? 8 : -1);
  if (fmt == SAMPLEFORMAT_INT)
    return bits == 8 ? 4 : bits == 16 ? 5 : bits == 32 ? 6 : -1;
  // unsigned (or unspecified)
  return bits == 8 ? 1 : bits == 16 ? 2 : bits == 32 ? 3 : -1;
}

struct Info {
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, bits = 8, fmt = SAMPLEFORMAT_UINT, planar = PLANARCONFIG_CONTIG;
  int bytes_per_sample() const { return bits / 8; }
};

int read_info(TIFF* tif, Info* info) {
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &info->width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &info->height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &info->spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &info->bits);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &info->fmt);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &info->planar);
  if (info->bits % 8 != 0) return kErrUnsupported;
  return 0;
}

// Blit a decoded contiguous block into the HWC output.
void blit(uint8_t* out, const uint8_t* block, const Info& info, uint32_t y0,
          uint32_t x0, uint32_t bh, uint32_t bw, uint32_t block_row_px,
          int plane /* -1 = chunky */) {
  const int bps = info.bytes_per_sample();
  const size_t out_row_bytes = size_t(info.width) * info.spp * bps;
  if (plane < 0) {
    const size_t block_row_bytes = size_t(block_row_px) * info.spp * bps;
    const size_t copy_bytes = size_t(bw) * info.spp * bps;
    for (uint32_t r = 0; r < bh; ++r) {
      std::memcpy(out + (y0 + r) * out_row_bytes + size_t(x0) * info.spp * bps,
                  block + r * block_row_bytes, copy_bytes);
    }
  } else {
    // separate planes: scatter one band into the interleaved layout
    for (uint32_t r = 0; r < bh; ++r) {
      const uint8_t* src = block + size_t(r) * block_row_px * bps;
      uint8_t* dst =
          out + (y0 + r) * out_row_bytes + (size_t(x0) * info.spp + plane) * bps;
      for (uint32_t c = 0; c < bw; ++c) {
        std::memcpy(dst + size_t(c) * info.spp * bps, src + size_t(c) * bps, bps);
      }
    }
  }
}

}  // namespace

extern "C" {

int gdl_tiff_read_info(const char* path, int32_t* width, int32_t* height,
                       int32_t* channels, int32_t* dtype) {
  TIFFSetErrorHandler(nullptr);
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrOpen;
  Info info;
  int rc = read_info(tif, &info);
  if (rc == 0) {
    *width = int32_t(info.width);
    *height = int32_t(info.height);
    *channels = int32_t(info.spp);
    *dtype = dtype_code(info.bits, info.fmt);
    if (*dtype < 0) rc = kErrUnsupported;
  }
  TIFFClose(tif);
  return rc;
}

int gdl_tiff_read(const char* path, uint8_t* out) {
  TIFFSetErrorHandler(nullptr);
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrOpen;
  Info info;
  int rc = read_info(tif, &info);
  if (rc != 0) {
    TIFFClose(tif);
    return rc;
  }
  const int planes = info.planar == PLANARCONFIG_SEPARATE ? info.spp : 1;

  if (TIFFIsTiled(tif)) {
    uint32_t tw = 0, th = 0;
    TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tw);
    TIFFGetField(tif, TIFFTAG_TILELENGTH, &th);
    std::vector<uint8_t> buf(TIFFTileSize(tif));
    for (int p = 0; p < planes; ++p) {
      for (uint32_t y = 0; y < info.height; y += th) {
        for (uint32_t x = 0; x < info.width; x += tw) {
          ttile_t tile = TIFFComputeTile(tif, x, y, 0, uint16_t(p));
          if (TIFFReadEncodedTile(tif, tile, buf.data(), buf.size()) < 0) {
            TIFFClose(tif);
            return kErrRead;
          }
          uint32_t bh = std::min(th, info.height - y);
          uint32_t bw = std::min(tw, info.width - x);
          blit(out, buf.data(), info, y, x, bh, bw, tw,
               planes > 1 ? p : -1);
        }
      }
    }
  } else {
    uint32_t rps = info.height;
    TIFFGetFieldDefaulted(tif, TIFFTAG_ROWSPERSTRIP, &rps);
    std::vector<uint8_t> buf(TIFFStripSize(tif));
    for (int p = 0; p < planes; ++p) {
      for (uint32_t y = 0; y < info.height; y += rps) {
        tstrip_t strip = TIFFComputeStrip(tif, y, uint16_t(p));
        tmsize_t n = TIFFReadEncodedStrip(tif, strip, buf.data(), buf.size());
        if (n < 0) {
          TIFFClose(tif);
          return kErrRead;
        }
        uint32_t bh = std::min(rps, info.height - y);
        blit(out, buf.data(), info, y, 0, bh, info.width, info.width,
             planes > 1 ? p : -1);
      }
    }
  }
  TIFFClose(tif);
  return 0;
}

}  // extern "C"
