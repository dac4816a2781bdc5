// htkio — native codec + bulk loader for HTK feature files.
//
// The native analogue of the byte-crunching C that HTK's HParm/HShell
// do on every file open (byte-order swaps, _C decompression, CRC16): batch
// corpus loading is host-bound work that feeds the device input pipeline,
// so it runs in C++ (loaded via ctypes; htk_jax.io.htkfeat falls back to
// the numpy path when the library isn't built).
//
// Layout notes: HTK feature files are big-endian; the decoder swaps to
// host little-endian and decompresses  x = (c + B) / A  in one pass.
//
// Build: cc -O3 -shared -fPIC htkio.cpp -o libhtkio.so   (see build.py)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

static inline uint32_t swap32(uint32_t v) {
  return __builtin_bswap32(v);
}
static inline uint16_t swap16(uint16_t v) {
  return __builtin_bswap16(v);
}

// CCITT CRC-16 (poly 0x1021, init 0xffff) over a byte buffer.
uint16_t htkio_crc16(const uint8_t* data, int64_t n) {
  uint16_t crc = 0xffff;
  for (int64_t i = 0; i < n; i++) {
    crc ^= (uint16_t)(data[i]) << 8;
    for (int k = 0; k < 8; k++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x1021)
                           : (uint16_t)(crc << 1);
  }
  return crc;
}

// Swap big-endian float32 payload to host order, in place.
void htkio_swap_f32(uint32_t* buf, int64_t n) {
  for (int64_t i = 0; i < n; i++) buf[i] = swap32(buf[i]);
}

void htkio_swap_i16(uint16_t* buf, int64_t n) {
  for (int64_t i = 0; i < n; i++) buf[i] = swap16(buf[i]);
}

// Decompress HTK _C payload: int16 (big-endian) q, vectors A,B (host
// order float32, length w): out[t,j] = (q[t,j] + B[j]) / A[j].
void htkio_decompress(const int16_t* q_be, const float* A, const float* B,
                      int64_t rows, int64_t w, float* out) {
  for (int64_t t = 0; t < rows; t++) {
    const int16_t* row = q_be + t * w;
    float* orow = out + t * w;
    for (int64_t j = 0; j < w; j++) {
      int16_t v = (int16_t)swap16((uint16_t)row[j]);
      orow[j] = ((float)v + B[j]) / A[j];
    }
  }
}

// Compress: q[t,j] = clamp(round(A[j]*x[t,j] - B[j])), written big-endian.
void htkio_compress(const float* x, const float* A, const float* B,
                    int64_t rows, int64_t w, int16_t* q_be) {
  for (int64_t t = 0; t < rows; t++) {
    const float* row = x + t * w;
    int16_t* orow = q_be + t * w;
    for (int64_t j = 0; j < w; j++) {
      float v = A[j] * row[j] - B[j];
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32767.0f) v = -32767.0f;
      long r = lroundf(v);
      orow[j] = (int16_t)swap16((uint16_t)(int16_t)r);
    }
  }
}

// Bulk loader: read one HTK feature file (uncompressed float32 or _C
// compressed) straight into out (row-major float32, host order).
// Returns number of frames, or negative error codes:
//   -1 open failed   -2 short read   -3 width mismatch   -4 CRC mismatch
int64_t htkio_load(const char* path, float* out, int64_t max_frames,
                   int64_t expect_width, int32_t* samp_period,
                   int32_t* parm_kind) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) { fclose(f); return -2; }
  int32_t n = (int32_t)swap32(*(uint32_t*)hdr);
  int32_t period = (int32_t)swap32(*(uint32_t*)(hdr + 4));
  int16_t samp_size = (int16_t)swap16(*(uint16_t*)(hdr + 8));
  int16_t kind = (int16_t)swap16(*(uint16_t*)(hdr + 10));
  *samp_period = period;
  *parm_kind = kind;
  bool compressed = (kind & 0x400) != 0;
  bool with_crc = (kind & 0x1000) != 0;

  if (compressed) {
    int64_t w = samp_size / 2;
    int64_t rows = n - 4;
    if (expect_width && w != expect_width) { fclose(f); return -3; }
    if (rows > max_frames) rows = max_frames;
    float* A = (float*)malloc(w * 4);
    float* B = (float*)malloc(w * 4);
    if (fread(A, 4, w, f) != (size_t)w || fread(B, 4, w, f) != (size_t)w) {
      free(A); free(B); fclose(f); return -2;
    }
    htkio_swap_f32((uint32_t*)A, w);
    htkio_swap_f32((uint32_t*)B, w);
    int16_t* q = (int16_t*)malloc(rows * w * 2);
    if (fread(q, 2, rows * w, f) != (size_t)(rows * w)) {
      free(A); free(B); free(q); fclose(f); return -2;
    }
    htkio_decompress(q, A, B, rows, w, out);
    free(A); free(B); free(q);
    fclose(f);
    return rows;
  }

  int64_t w = samp_size / 4;
  if (expect_width && w != expect_width) { fclose(f); return -3; }
  int64_t rows = n > max_frames ? max_frames : n;
  if (fread(out, 4, rows * w, f) != (size_t)(rows * w)) {
    fclose(f); return -2;
  }
  htkio_swap_f32((uint32_t*)out, rows * w);
  fclose(f);
  return rows;
}

// Batch corpus loader: load n_files HTK files into one packed arena.
// paths: concatenated NUL-separated path strings. out: arena of
// max_frames_per * width floats per file slot. frames_out[i] receives the
// frame count (or negative error) per file. Returns count of successful
// files. One Python->C call per corpus pass instead of per file.
int64_t htkio_load_batch(const char* paths, int64_t n_files, float* out,
                         int64_t max_frames_per, int64_t width,
                         int32_t* periods, int32_t* kinds,
                         int64_t* frames_out) {
  const char* p = paths;
  int64_t ok = 0;
  for (int64_t i = 0; i < n_files; i++) {
    frames_out[i] = htkio_load(p, out + i * max_frames_per * width,
                               max_frames_per, width, periods + i, kinds + i);
    if (frames_out[i] >= 0) ok++;
    p += strlen(p) + 1;
  }
  return ok;
}

// MLF structure scan (HLabel.c LoadMasterFile's hot loop): one pass
// collecting, per line, the trimmed span when the line is an entry
// pattern ('"' first byte; tag 1) or a lone '.' terminator (tag 2).
// Returns mark count, or -(needed) when cap is too small.
int64_t htkio_mlf_marks(const uint8_t* buf, int64_t n, int64_t* offs,
                        int64_t* ends, uint8_t* tags, int64_t cap) {
  int64_t cnt = 0, i = 0;
  while (i < n) {
    int64_t ls = i;
    while (i < n && buf[i] != '\n') i++;
    int64_t le = i;
    i++;
    int64_t a = ls;
    while (a < le && (buf[a] == ' ' || buf[a] == '\t' || buf[a] == '\r')) a++;
    int64_t b = le;
    while (b > a && (buf[b - 1] == ' ' || buf[b - 1] == '\t' ||
                     buf[b - 1] == '\r'))
      b--;
    if (a >= b) continue;
    uint8_t tag = 0;
    if (buf[a] == '"') tag = 1;
    else if (b - a == 1 && buf[a] == '.') tag = 2;
    if (tag) {
      if (cnt >= cap) return -(cnt + 1);
      offs[cnt] = a;
      ends[cnt] = b;
      tags[cnt] = tag;
      cnt++;
    }
  }
  return cnt;
}

}  // extern "C"
