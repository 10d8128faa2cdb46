// Native BigFile feature store: mmap + threaded row gather.
//
// The reference reads features with per-call open + sorted seek loops in
// Python (LINAS-engine/basic/bigfile.py:4-61).  Here the float32 matrix is
// mmap'd once and batch gathers run as parallel memcpy into one contiguous
// output buffer the Python side hands straight to jax.device_put.
//
// C ABI (ctypes):
//   bf_open(path, n_rows, n_dims) -> handle (or 0)
//   bf_gather(handle, rows*, n, out*)  (out must hold n*n_dims floats)
//   bf_close(handle)

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct BigFile {
  const float* data = nullptr;
  size_t bytes = 0;
  int64_t n_rows = 0;
  int64_t n_dims = 0;
  int fd = -1;
};

}  // namespace

extern "C" {

void* bf_open(const char* path, int64_t n_rows, int64_t n_dims) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  size_t bytes = static_cast<size_t>(n_rows) * n_dims * sizeof(float);
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < bytes) {
    ::close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, bytes, PROT_READ, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(p, bytes, MADV_WILLNEED);
  auto* bf = new BigFile;
  bf->data = static_cast<const float*>(p);
  bf->bytes = bytes;
  bf->n_rows = n_rows;
  bf->n_dims = n_dims;
  bf->fd = fd;
  return bf;
}

int bf_gather(void* handle, const int64_t* rows, int64_t n, float* out,
              int n_threads) {
  auto* bf = static_cast<BigFile*>(handle);
  if (!bf) return -1;
  const int64_t dims = bf->n_dims;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = rows[i];
      if (r < 0 || r >= bf->n_rows) {
        memset(out + i * dims, 0, dims * sizeof(float));
      } else {
        memcpy(out + i * dims, bf->data + r * dims, dims * sizeof(float));
      }
    }
  };
  if (n_threads <= 1 || n < 4 * n_threads) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
  return 0;
}

void bf_close(void* handle) {
  auto* bf = static_cast<BigFile*>(handle);
  if (!bf) return;
  munmap(const_cast<float*>(bf->data), bf->bytes);
  ::close(bf->fd);
  delete bf;
}

}  // extern "C"
