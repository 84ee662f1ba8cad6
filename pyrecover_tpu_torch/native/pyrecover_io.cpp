// pyrecover_io — native checkpoint I/O engine of the PyTorch port.
//
// A copy of the JAX package's native/pyrecover_io.cpp (the port builds and
// binds its own, and imports nothing of the JAX package), plus
// pr_pread_into, which reads one byte range of a file with parallel pread
// so a checkpoint is restored a leaf at a time without a whole-file buffer.
// Multithreaded chunked file write/read with an xxh64-based tree checksum
// computed in the same pass; exposed to Python through a plain C ABI
// (ctypes, pyrecover_tpu_torch/checkpoint/native_io.py).
//
// Checksum scheme (the JAX package's, so either package verifies the
// other's sidecars): the file is split into fixed CHUNK-sized pieces; each
// piece is xxh64-hashed independently (parallel); the final digest is the
// xxh64 of the concatenated per-chunk digests.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 -o libpyrecover_io.so pyrecover_io.cpp

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------- xxh64 (public algorithm, from the spec) ----------------
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/arm LE)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round1(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p)); p += 8;
      v2 = round1(v2, read64(p)); p += 8;
      v3 = round1(v3, read64(p)); p += 8;
      v4 = round1(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

size_t num_chunks(size_t n, size_t chunk) { return n == 0 ? 1 : (n + chunk - 1) / chunk; }

uint64_t combine_digests(const std::vector<uint64_t>& digests) {
  return xxh64(reinterpret_cast<const uint8_t*>(digests.data()),
               digests.size() * sizeof(uint64_t), 0);
}

int clamp_threads(int n_threads, size_t chunks) {
  unsigned hw = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = hw ? static_cast<int>(hw) : 4;
  if (static_cast<size_t>(n_threads) > chunks) n_threads = static_cast<int>(chunks);
  return n_threads < 1 ? 1 : n_threads;
}

template <typename Fn>
bool parallel_chunks(size_t n, size_t chunk, int n_threads, Fn&& fn) {
  size_t chunks = num_chunks(n, chunk);
  n_threads = clamp_threads(n_threads, chunks);
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= chunks || !ok.load()) return;
      size_t off = i * chunk;
      size_t len = (off + chunk <= n) ? chunk : (n - off);
      if (!fn(i, off, len)) ok.store(false);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // namespace

extern "C" {

// xxh64 of a memory buffer (seed 0). For tests / small payloads.
uint64_t pr_xxh64(const void* data, uint64_t len) {
  return xxh64(static_cast<const uint8_t*>(data), len, 0);
}

// Tree checksum of a memory buffer.
uint64_t pr_tree_hash(const void* data, uint64_t len, uint64_t chunk,
                      int n_threads) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  size_t chunks = num_chunks(len, chunk);
  std::vector<uint64_t> digests(chunks);
  parallel_chunks(len, chunk, n_threads, [&](size_t i, size_t off, size_t n) {
    digests[i] = xxh64(p + off, n, 0);
    return true;
  });
  return combine_digests(digests);
}

// Parallel write of a buffer to a file; returns the tree checksum of the
// buffer (computed while writing) or 0 on failure with *err set.
uint64_t pr_write_file(const char* path, const void* data, uint64_t len,
                       uint64_t chunk, int n_threads, int* err) {
  *err = 0;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) { *err = errno; return 0; }
  if (::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    *err = errno; ::close(fd); return 0;
  }
  const uint8_t* p = static_cast<const uint8_t*>(data);
  size_t chunks = num_chunks(len, chunk);
  std::vector<uint64_t> digests(chunks);
  bool ok = parallel_chunks(len, chunk, n_threads,
                            [&](size_t i, size_t off, size_t n) {
    size_t done = 0;
    while (done < n) {
      ssize_t w = ::pwrite(fd, p + off + done, n - done,
                           static_cast<off_t>(off + done));
      if (w < 0) { *err = errno; return false; }
      done += static_cast<size_t>(w);
    }
    digests[i] = xxh64(p + off, n, 0);
    return true;
  });
  if (::fsync(fd) != 0 && *err == 0) *err = errno;
  ::close(fd);
  if (!ok || *err != 0) return 0;
  return combine_digests(digests);
}

// Parallel read of a whole file into a caller-provided buffer (size must
// match the file size); returns the tree checksum or 0 on failure.
uint64_t pr_read_file(const char* path, void* data, uint64_t len,
                      uint64_t chunk, int n_threads, int* err) {
  *err = 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) { *err = errno; return 0; }
  uint8_t* p = static_cast<uint8_t*>(data);
  size_t chunks = num_chunks(len, chunk);
  std::vector<uint64_t> digests(chunks);
  bool ok = parallel_chunks(len, chunk, n_threads,
                            [&](size_t i, size_t off, size_t n) {
    size_t done = 0;
    while (done < n) {
      ssize_t r = ::pread(fd, p + off + done, n - done,
                          static_cast<off_t>(off + done));
      if (r < 0) { *err = errno; return false; }
      if (r == 0) { *err = EIO; return false; }  // short file
      done += static_cast<size_t>(r);
    }
    digests[i] = xxh64(p + off, n, 0);
    return true;
  });
  ::close(fd);
  if (!ok || *err != 0) return 0;
  return combine_digests(digests);
}

// Tree checksum of a file without keeping it in memory (streaming verify).
uint64_t pr_hash_file(const char* path, uint64_t chunk, int n_threads,
                      int* err) {
  *err = 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) { *err = errno; return 0; }
  struct stat st;
  if (::fstat(fd, &st) != 0) { *err = errno; ::close(fd); return 0; }
  uint64_t len = static_cast<uint64_t>(st.st_size);
  size_t chunks = num_chunks(len, chunk);
  std::vector<uint64_t> digests(chunks);
  bool ok = parallel_chunks(len, chunk, n_threads,
                            [&](size_t i, size_t off, size_t n) {
    std::vector<uint8_t> buf(n);
    size_t done = 0;
    while (done < n) {
      ssize_t r = ::pread(fd, buf.data() + done, n - done,
                          static_cast<off_t>(off + done));
      if (r <= 0) { *err = r < 0 ? errno : EIO; return false; }
      done += static_cast<size_t>(r);
    }
    digests[i] = xxh64(buf.data(), n, 0);
    return true;
  });
  ::close(fd);
  if (!ok || *err != 0) return 0;
  return combine_digests(digests);
}

// Parallel pread of len bytes at offset of a file into a caller-provided
// buffer. Returns the number of bytes read (len) or 0 with *err set; a file
// that ends before offset + len is EIO.
uint64_t pr_pread_into(const char* path, uint64_t offset, void* data, uint64_t len,
                       uint64_t chunk, int n_threads, int* err) {
  *err = 0;
  if (len == 0) return 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) { *err = errno; return 0; }
  uint8_t* p = static_cast<uint8_t*>(data);
  bool ok = parallel_chunks(len, chunk, n_threads,
                            [&](size_t, size_t off, size_t n) {
    size_t done = 0;
    while (done < n) {
      ssize_t r = ::pread(fd, p + off + done, n - done,
                          static_cast<off_t>(offset + off + done));
      if (r < 0) { *err = errno; return false; }
      if (r == 0) { *err = EIO; return false; }  // short file
      done += static_cast<size_t>(r);
    }
    return true;
  });
  ::close(fd);
  if (!ok || *err != 0) return 0;
  return len;
}

uint64_t pr_file_size(const char* path, int* err) {
  *err = 0;
  struct stat st;
  if (::stat(path, &st) != 0) { *err = errno; return 0; }
  return static_cast<uint64_t>(st.st_size);
}

}  // extern "C"
