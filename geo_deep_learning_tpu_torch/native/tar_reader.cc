// Native tar-shard reader — streaming member iteration for the
// multi-sensor shard pipeline (data/shard_dataset.py).
//
// The Python tarfile module re-parses headers and allocates per member in
// the interpreter; this reader walks the 512-byte header blocks in C++
// and hands back (name, payload) pairs through a simple handle-based C
// ABI. Handles ustar, pax ('x' extended headers: the overriding ``path``
// record is parsed), and GNU ('L' long-name entries) archives; names that
// exceed the 4 KiB buffer return an error so the caller can fall back to
// Python tarfile for that shard.
//
//   void* gdl_tar_open(const char* path)
//   int   gdl_tar_next(void* h, char* name_out /*>=4096B*/, int64_t* size)
//           -> 1 member available, 0 end-of-archive, <0 error
//   int   gdl_tar_read(void* h, uint8_t* buf)   // read current payload
//   void  gdl_tar_close(void* h)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

constexpr size_t kNameMax = 4095;  // name_out buffer is 4096 incl. NUL

struct TarHandle {
  FILE* f = nullptr;
  int64_t payload_size = 0;   // size of the current member
  int64_t payload_left = 0;   // unread bytes of current member (incl. pad)
  std::string pending_name;   // override from a GNU 'L' / pax 'x' entry
};

int64_t parse_octal(const char* p, int n) {
  // tar numeric fields: octal ASCII, or base-256 when the high bit is set
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (int i = 1; i < n; ++i) v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') break;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

bool zero_block(const char* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

void skip_payload(TarHandle* h) {
  if (h->payload_left > 0) {
    fseek(h->f, h->payload_left, SEEK_CUR);
    h->payload_left = 0;
  }
}

// Read a metadata entry's payload (padded to 512) into a string.
bool read_meta_payload(TarHandle* h, int64_t size, int64_t padded,
                       std::string* out) {
  if (size < 0 || size > int64_t(1) << 20) return false;  // sanity bound
  out->resize(size_t(size));
  if (size > 0 && fread(&(*out)[0], 1, size_t(size), h->f) != size_t(size))
    return false;
  if (padded > size) fseek(h->f, padded - size, SEEK_CUR);
  return true;
}

// pax extended header: a sequence of "<len> <key>=<value>\n" records where
// <len> is the decimal length of the whole record. Extracts "path".
bool parse_pax_path(const std::string& data, std::string* path_out) {
  size_t pos = 0;
  while (pos < data.size()) {
    size_t sp = data.find(' ', pos);
    if (sp == std::string::npos) return false;
    long rec_len = strtol(data.c_str() + pos, nullptr, 10);
    if (rec_len <= 0 || pos + size_t(rec_len) > data.size()) return false;
    size_t eq = data.find('=', sp + 1);
    size_t rec_end = pos + size_t(rec_len);  // record ends with '\n'
    if (eq != std::string::npos && eq < rec_end) {
      std::string key = data.substr(sp + 1, eq - sp - 1);
      if (key == "path")
        *path_out = data.substr(eq + 1, rec_end - eq - 2);  // drop '\n'
    }
    pos = rec_end;
  }
  return true;
}

}  // namespace

extern "C" {

void* gdl_tar_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new TarHandle();
  h->f = f;
  return h;
}

int gdl_tar_next(void* handle, char* name_out, int64_t* size_out) {
  auto* h = static_cast<TarHandle*>(handle);
  skip_payload(h);
  char block[512];
  while (true) {
    if (fread(block, 1, 512, h->f) != 512) return 0;  // truncated = EOF
    if (zero_block(block)) return 0;                  // end marker
    const char typeflag = block[156];
    int64_t size = parse_octal(block + 124, 12);
    int64_t padded = (size + 511) & ~int64_t(511);
    if (typeflag == 'L') {  // GNU long name: payload = next member's name
      std::string data;
      if (!read_meta_payload(h, size, padded, &data)) return -2;
      data.resize(strnlen(data.c_str(), data.size()));  // trim trailing NULs
      if (data.size() > kNameMax) return -3;
      h->pending_name = data;
      continue;
    }
    if (typeflag == 'x') {  // pax extended header: parse overriding path
      std::string data;
      if (!read_meta_payload(h, size, padded, &data)) return -2;
      std::string path;
      if (!parse_pax_path(data, &path)) return -2;
      if (path.size() > kNameMax) return -3;
      if (!path.empty()) h->pending_name = path;
      continue;
    }
    const bool is_file = typeflag == '0' || typeflag == '\0';
    if (!is_file) {  // dirs, links, 'K' long-linkname, 'g' globals: skip
      fseek(h->f, padded, SEEK_CUR);
      continue;
    }
    if (!h->pending_name.empty()) {
      memcpy(name_out, h->pending_name.c_str(), h->pending_name.size() + 1);
      h->pending_name.clear();
    } else {
      // ustar name: prefix (345, 155 bytes) + '/' + name (0, 100 bytes)
      size_t pos = 0;
      if (block[345]) {
        size_t plen = strnlen(block + 345, 155);
        memcpy(name_out, block + 345, plen);
        pos = plen;
        name_out[pos++] = '/';
      }
      size_t nlen = strnlen(block, 100);
      memcpy(name_out + pos, block, nlen);
      name_out[pos + nlen] = '\0';
    }
    *size_out = size;
    h->payload_size = size;
    h->payload_left = padded;
    return 1;
  }
}

int gdl_tar_read(void* handle, uint8_t* buf) {
  auto* h = static_cast<TarHandle*>(handle);
  if (h->payload_left < h->payload_size) return -1;  // already consumed
  if (fread(buf, 1, h->payload_size, h->f) != size_t(h->payload_size)) return -2;
  h->payload_left -= h->payload_size;
  return 0;
}

void gdl_tar_close(void* handle) {
  auto* h = static_cast<TarHandle*>(handle);
  if (h->f) fclose(h->f);
  delete h;
}

}  // extern "C"
