// Native RecordIO engine (host runtime component of mxnet_tpu_torch).
//
// The data path between disk and the host staging buffer is CPU-bound Python
// in the fallback implementation; this C++ engine provides the same
// dmlc-style framing
//
//     [kMagic u32][(cflag<<29)|length u32][payload][pad to 4B]
//
// (cflag: 0 whole, 1 first, 2 middle, 3 last chunk) with buffered
// sequential IO and a thread-pooled batched random-access reader used by
// the ImageRecordIter prefetch pipeline.  Reference analogs:
// dmlc-core recordio.h framing; src/io/iter_image_recordio_2.cc's
// multi-threaded record loader.  Re-implemented from the published
// format specification, not translated code.
//
// C ABI only (consumed via ctypes -- no pybind11 in the image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xCED7230A;
constexpr uint32_t kMaxChunk = (1u << 29) - 1;
constexpr size_t kBufSize = 1u << 20;  // 1 MiB stdio buffer

struct Rio {
  FILE* f = nullptr;
  bool writable = false;
  std::vector<char> iobuf;
};

// Read one framed record (reassembling chunks) from f at its current
// position.  Returns malloc'd buffer in *out and its length, -1 on
// clean EOF, -2 on corruption.
long read_record(FILE* f, char** out) {
  std::string data;
  for (;;) {
    uint32_t hdr[2];
    size_t got = fread(hdr, 1, sizeof(hdr), f);
    if (got < sizeof(hdr)) {
      if (data.empty() && got == 0) return -1;  // clean EOF
      return -2;                                // truncated
    }
    if (hdr[0] != kMagic) return -2;
    uint32_t cflag = hdr[1] >> 29;
    uint32_t length = hdr[1] & kMaxChunk;
    size_t old = data.size();
    data.resize(old + length);
    if (length && fread(&data[old], 1, length, f) != length) return -2;
    uint32_t pad = (4 - length % 4) % 4;
    if (pad && fseek(f, pad, SEEK_CUR) != 0) return -2;
    if (cflag == 0 || cflag == 3) break;
  }
  char* buf = static_cast<char*>(malloc(data.size() ? data.size() : 1));
  if (!buf) return -2;
  memcpy(buf, data.data(), data.size());
  *out = buf;
  return static_cast<long>(data.size());
}

int write_chunk(FILE* f, uint32_t cflag, const char* buf, uint32_t len) {
  uint32_t hdr[2] = {kMagic, (cflag << 29) | len};
  if (fwrite(hdr, 1, sizeof(hdr), f) != sizeof(hdr)) return -1;
  if (len && fwrite(buf, 1, len, f) != len) return -1;
  uint32_t pad = (4 - len % 4) % 4;
  static const char zeros[4] = {0, 0, 0, 0};
  if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  return 0;
}

}  // namespace

extern "C" {

void* rio_open(const char* path, int writable) {
  Rio* r = new Rio();
  r->f = fopen(path, writable ? "wb" : "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  r->writable = writable != 0;
  r->iobuf.resize(kBufSize);
  setvbuf(r->f, r->iobuf.data(), _IOFBF, r->iobuf.size());
  return r;
}

void rio_close(void* h) {
  Rio* r = static_cast<Rio*>(h);
  if (!r) return;
  if (r->f) fclose(r->f);
  delete r;
}

long rio_tell(void* h) {
  Rio* r = static_cast<Rio*>(h);
  return r && r->f ? ftell(r->f) : -1;
}

int rio_seek(void* h, long offset) {
  Rio* r = static_cast<Rio*>(h);
  if (!r || !r->f) return -1;
  return fseek(r->f, offset, SEEK_SET);
}

int rio_flush(void* h) {
  Rio* r = static_cast<Rio*>(h);
  if (!r || !r->f) return -1;
  return fflush(r->f);
}

// Write one record, splitting payloads over 2^29-1 bytes into
// first/middle/last chunks.  Returns 0, or -1 on IO error.
int rio_write(void* h, const char* buf, long len) {
  Rio* r = static_cast<Rio*>(h);
  if (!r || !r->f || !r->writable) return -1;
  if (len <= static_cast<long>(kMaxChunk))
    return write_chunk(r->f, 0, buf, static_cast<uint32_t>(len));
  long pos = 0;
  bool first = true;
  while (pos < len) {
    long n = len - pos;
    if (n > static_cast<long>(kMaxChunk)) n = kMaxChunk;
    uint32_t cflag = first ? 1u : (pos + n >= len ? 3u : 2u);
    if (write_chunk(r->f, cflag, buf + pos, static_cast<uint32_t>(n)) != 0)
      return -1;
    first = false;
    pos += n;
  }
  return 0;
}

// Read the next record.  *out receives a malloc'd buffer (free with
// rio_free).  Returns payload length, -1 on EOF, -2 on corruption.
long rio_read(void* h, char** out) {
  Rio* r = static_cast<Rio*>(h);
  if (!r || !r->f || r->writable) return -2;
  return read_record(r->f, out);
}

void rio_free(char* buf) { free(buf); }

// Batched random-access read: n records at the given byte offsets, each
// on its own FILE* so reads run concurrently across `nthreads` workers
// (the prefetch half of the reference's threaded record loader).
// bufs[i] receives a malloc'd payload, lens[i] its length (-2 for a bad
// record).  Returns 0, or -1 if the file cannot be opened.
int rio_read_batch(const char* path, const long* offsets, int n,
                   char** bufs, long* lens, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::vector<std::thread> pool;
  std::atomic<bool> open_failed{false};
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t]() {
      FILE* f = fopen(path, "rb");
      if (!f) {
        open_failed = true;
        return;
      }
      std::vector<char> buf(kBufSize);
      setvbuf(f, buf.data(), _IOFBF, buf.size());
      for (int i = t; i < n; i += nthreads) {
        if (fseek(f, offsets[i], SEEK_SET) != 0) {
          lens[i] = -2;
          continue;
        }
        char* out = nullptr;
        long len = read_record(f, &out);
        bufs[i] = out;
        lens[i] = len;
      }
      fclose(f);
    });
  }
  for (auto& th : pool) th.join();
  return open_failed.load() ? -1 : 0;
}

}  // extern "C"
