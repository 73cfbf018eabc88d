// Native host-side components for parallel_nbody_tpu.
//
// The reference's native pieces are two C programs (nbody-seq.c/nbody-par.c);
// the device compute path replaces their kernels with XLA/Pallas, but two
// host-side pieces stay native for exactness and speed:
//
//   1. glibc rand() (TYPE_3 additive feedback) replica + the reference's
//      initialization loop (nbody-seq.c:440-449).  At N=10M the O(N) Python
//      init loop costs tens of seconds; this runs in milliseconds and is
//      bit-identical to the Python fallback (utils/glibc_rand.py).
//   2. mmap-based in-place PPM frame blit (the display+msync analog,
//      nbody-seq.c:467-471) for high-rate animation dumps.
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// glibc TYPE_3 random(): degree 31, separation 3, 34-word state.
class GlibcRand {
 public:
  explicit GlibcRand(uint32_t seed) {
    if (seed == 0) seed = 1;
    int32_t word = static_cast<int32_t>(seed);
    r_[0] = static_cast<uint32_t>(word);
    for (int i = 1; i < 31; ++i) {
      // word = (16807 * word) % 2147483647 via Schrage's method.
      int64_t hi = word / 127773;
      int64_t lo = word % 127773;
      int64_t w = 16807 * lo - 2836 * hi;
      if (w < 0) w += 2147483647;
      word = static_cast<int32_t>(w);
      r_[i] = static_cast<uint32_t>(word);
    }
    for (int i = 31; i < 34; ++i) r_[i] = r_[i - 31];
    k_ = 34;
    for (int i = 0; i < 310; ++i) next();
  }

  uint32_t next() {
    uint32_t v = r_[(k_ - 31) % 34] + r_[(k_ - 3) % 34];
    r_[k_ % 34] = v;
    ++k_;
    return v >> 1;
  }

 private:
  uint32_t r_[34];
  uint64_t k_;
};

}  // namespace

extern "C" {

// Fill n draws of rand() after srand(seed).
void nbody_glibc_rand_fill(uint32_t seed, int64_t n, int64_t* out) {
  GlibcRand rng(seed);
  for (int64_t i = 0; i < n; ++i) out[i] = rng.next();
}

// Reference init loop (nbody-seq.c:440-449): positions, velocities, radius,
// mass for n bodies in a (xdim, ydim) arena.  All outputs length n, float64.
void nbody_init(uint32_t seed, int64_t n, int32_t xdim, int32_t ydim,
                double* x, double* y, double* xv, double* yv,
                double* mass, double* radius) {
  GlibcRand rng(seed);
  const double diag =
      std::sqrt(1.0 * (static_cast<double>(xdim) * xdim +
                       static_cast<double>(ydim) * ydim));
  const double denom = 25.0 * (static_cast<double>(n) * n + 1.0);
  for (int64_t b = 0; b < n; ++b) {
    x[b] = static_cast<double>(rng.next() % xdim);
    y[b] = static_cast<double>(rng.next() % ydim);
    const double bb = static_cast<double>(b) * static_cast<double>(b);
    const double r = 1.0 + ((bb + 1.0) * diag) / denom;
    radius[b] = r;
    mass[b] = r * r * r;
    xv[b] = ((static_cast<int64_t>(rng.next() % 20000)) - 10000) / 2000.0;
    yv[b] = ((static_cast<int64_t>(rng.next() % 20000)) - 10000) / 2000.0;
  }
}

// Render the reference's final-state printout (print, nbody-seq.c:356-365):
// one "%10.3f %10.3f %10.3f %10.3f %10.3f %10.3f\n" line per body, written
// into `out` (caller-sized; each line is at most line_cap bytes).  Returns
// the number of bytes written, or -1 if a line would overflow line_cap.
// snprintf IS the reference's printf, so rounding/width semantics are
// inherited rather than re-implemented.
int64_t nbody_format_state(int64_t n,
                           const double* x, const double* y,
                           const double* xf, const double* yf,
                           const double* xv, const double* yv,
                           char* out, int64_t line_cap) {
  int64_t pos = 0;
  for (int64_t b = 0; b < n; ++b) {
    int w = snprintf(out + pos, static_cast<size_t>(line_cap),
                     "%10.3f %10.3f %10.3f %10.3f %10.3f %10.3f\n",
                     x[b], y[b], xf[b], yf[b], xv[b], yv[b]);
    if (w < 0 || w >= line_cap) return -1;
    pos += w;
  }
  return pos;
}

// mmap the pixel region of an existing PPM at data_offset and blit a frame,
// then msync. Returns 0 on success, -1 on failure.
int nbody_ppm_blit(const char* path, int64_t data_offset,
                   const uint8_t* pixels, int64_t nbytes) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < data_offset + nbytes) {
    close(fd);
    return -1;
  }
  void* map = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return -1;
  }
  std::memcpy(static_cast<uint8_t*>(map) + data_offset, pixels,
              static_cast<size_t>(nbytes));
  msync(map, static_cast<size_t>(st.st_size), MS_SYNC);
  munmap(map, static_cast<size_t>(st.st_size));
  close(fd);
  return 0;
}

}  // extern "C"
