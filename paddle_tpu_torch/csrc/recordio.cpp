// Chunked record IO + threaded prefetch: the port's native host data path.
//
// Parity: reference paddle/fluid/recordio/{chunk,scanner,writer}.cc (C++
// chunked record storage with per-record checksums) and the reader op
// chain's double-buffer thread (operators/reader/
// create_double_buffer_reader_op.cc), and the JAX package's
// csrc/recordio.cpp, of which this is the port's own copy. Host code, not a
// device kernel: zero-copy mmap record scanning, a streaming writer, and a
// background producer thread that stages records in a bounded ring so the
// train loop never blocks on disk.
//
// Exposed as a C ABI consumed via ctypes (paddle_tpu_torch/utils/
// native.py); the format is the pure-python RecordIOReader's
// (reader/recordio.py), byte for byte the JAX package's:
//   magic "PTRIO1\n" | per record: u32 payload_len | u32 crc32 | payload
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[] = "PTRIO1\n";
constexpr size_t kMagicLen = 7;

// crc32 (IEEE, zlib-compatible), slicing-by-8: eight 256-entry tables
// fold eight bytes a step (a byte at a time, as the JAX package's copy
// reads, the checksum bounds the scanner near 300 MB/s on a server core).
// The tables are built once, on first use, by a thread-safe static
// initializer (the writer and a prefetch thread may both come first).
using CrcTables = std::array<std::array<uint32_t, 256>, 8>;

const CrcTables& crc_tables() {
  static const CrcTables tables = [] {
    CrcTables t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    return t;
  }();
  return tables;
}

uint32_t crc32_ieee(const uint8_t* data, size_t n) {
  const CrcTables& t = crc_tables();
  uint32_t c = 0xFFFFFFFFu;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  for (; n >= 8; n -= 8, data += 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
#endif
  for (; n; --n, ++data) c = t[0][(c ^ *data) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Scanner {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  size_t off = 0;
  bool check_crc = true;
};

Scanner* open_scanner(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)kMagicLen) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_SEQUENTIAL);
  if (memcmp(base, kMagic, kMagicLen) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* s = new Scanner();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;
  s->off = kMagicLen;
  return s;
}

// returns payload length, sets *out to a pointer INTO the mapping (valid
// until close); -1 on EOF, -2 on corruption
ssize_t scanner_next(Scanner* s, const uint8_t** out) {
  if (s->off + 8 > s->size) {
    // 1-7 trailing bytes = a header truncated mid-write: corruption, not EOF
    return s->off == s->size ? -1 : -2;
  }
  uint32_t len, crc;
  memcpy(&len, s->base + s->off, 4);
  memcpy(&crc, s->base + s->off + 4, 4);
  s->off += 8;
  if (s->off + len > s->size) return -2;
  const uint8_t* payload = s->base + s->off;
  s->off += len;
  if (s->check_crc && crc32_ieee(payload, len) != crc) return -2;
  *out = payload;
  return (ssize_t)len;
}

void close_scanner(Scanner* s) {
  if (!s) return;
  if (s->base) munmap(const_cast<uint8_t*>(s->base), s->size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

// ---------------------------------------------------------------------------
// threaded prefetch: producer thread scans records into a bounded deque
// ---------------------------------------------------------------------------

struct Prefetcher {
  Scanner* scanner = nullptr;
  size_t depth = 4;
  std::deque<std::vector<uint8_t>> queue;
  std::vector<uint8_t> current;  // last record handed to the consumer
  // buffers the consumer is done with, reused by the producer so that a
  // record's copy neither allocates nor touches fresh pages
  std::vector<std::vector<uint8_t>> spare;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  bool done = false, error = false, stop = false;
  std::thread worker;

  void run() {
    for (;;) {
      const uint8_t* p = nullptr;
      ssize_t n = scanner_next(scanner, &p);
      std::vector<uint8_t> buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (n == -1 || n == -2 || stop) {
          error = (n == -2);
          done = true;
          cv_get.notify_all();
          return;
        }
        cv_put.wait(lk, [&] { return queue.size() < depth || stop; });
        if (stop) {
          done = true;
          cv_get.notify_all();
          return;
        }
        if (!spare.empty()) {
          buf = std::move(spare.back());
          spare.pop_back();
        }
      }
      // the copy runs outside the lock: the consumer may pop meanwhile,
      // and only this thread pushes, so the queue stays within depth
      buf.assign(p, p + n);
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(std::move(buf));
      cv_get.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// -- plain scanner ABI (see utils/native.py recordio_iter) --
void* ptrio_open(const char* path) { return open_scanner(path); }

// returns payload length; -1 on clean EOF, -2 on corruption
ssize_t ptrio_next(void* h, const char** out) {
  const uint8_t* p = nullptr;
  ssize_t n = scanner_next(static_cast<Scanner*>(h), &p);
  *out = reinterpret_cast<const char*>(p);
  return n;
}

void ptrio_close(void* h) { close_scanner(static_cast<Scanner*>(h)); }

// -- record writer (streaming append) --
void* ptrio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  fwrite(kMagic, 1, kMagicLen, f);
  return f;
}

int ptrio_writer_write(void* h, const char* data, uint64_t len) {
  FILE* f = static_cast<FILE*>(h);
  if (len > UINT32_MAX) return -1;  // u32 length field; don't truncate
  uint32_t l = (uint32_t)len;
  uint32_t crc = crc32_ieee(reinterpret_cast<const uint8_t*>(data), len);
  if (fwrite(&l, 4, 1, f) != 1) return -1;
  if (fwrite(&crc, 4, 1, f) != 1) return -1;
  if (len && fwrite(data, 1, len, f) != len) return -1;
  return 0;
}

void ptrio_writer_close(void* h) { fclose(static_cast<FILE*>(h)); }

// -- threaded prefetch ABI --
void* ptrio_prefetch_open(const char* path, uint64_t depth) {
  Scanner* s = open_scanner(path);
  if (!s) return nullptr;
  auto* p = new Prefetcher();
  p->scanner = s;
  p->depth = depth ? depth : 4;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// pops the next record; returns length (pointer valid until the next call
// or close), -1 on clean EOF, -2 on corruption
ssize_t ptrio_prefetch_next(void* h, const char** out) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_get.wait(lk, [&] { return !p->queue.empty() || p->done; });
  if (p->queue.empty()) return p->error ? -2 : -1;
  if (p->current.capacity()) p->spare.push_back(std::move(p->current));
  p->current = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_put.notify_one();
  *out = reinterpret_cast<const char*>(p->current.data());
  return (ssize_t)p->current.size();
}

void ptrio_prefetch_close(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_put.notify_all();
  }
  p->worker.join();
  close_scanner(p->scanner);
  delete p;
}

}  // extern "C"
