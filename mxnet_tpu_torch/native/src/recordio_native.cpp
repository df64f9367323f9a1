// Native RecordIO reader with threaded prefetch.
//
// Native analogue of the reference's C++ data-pipeline core
// (reference: dmlc-core include/dmlc/recordio.h RecordIOReader/Writer,
// src/io/iter_image_recordio_2.cc's prefetching reader threads). The
// Python framework calls this through ctypes (mxnet_tpu_torch/native/__init__.py);
// mxnet_tpu_torch/recordio.py keeps a pure-Python fallback so the wheel works
// without a toolchain.
//
// Wire format (dmlc-core, byte-compatible with the Python implementation):
//   [u32 magic=0xced7230a][u32 lrec](payload)(pad to 4)
//   lrec = cflag<<29 | length; cflag: 0 whole, 1 begin, 2 middle, 3 end.
//   Multipart records rejoin with the magic word re-inserted at splits.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> record;   // last assembled record
  std::string error;

  explicit Reader(const char* path) { f = std::fopen(path, "rb"); }
  ~Reader() {
    if (f) std::fclose(f);
  }

  // returns: 1 record ready, 0 EOF, -1 error
  int ReadChunk(uint32_t* cflag, std::vector<uint8_t>* out) {
    uint32_t header[2];
    size_t n = std::fread(header, 1, sizeof(header), f);
    if (n == 0) return 0;
    if (n != sizeof(header)) {
      error = "truncated record header";
      return -1;
    }
    if (header[0] != kMagic) {
      error = "invalid record magic";
      return -1;
    }
    *cflag = header[1] >> 29;
    uint32_t len = header[1] & ((1u << 29) - 1);
    out->resize(len);
    if (len && std::fread(out->data(), 1, len, f) != len) {
      error = "truncated record payload";
      return -1;
    }
    uint32_t pad = (4 - (len % 4)) % 4;
    if (pad) {
      uint8_t padbuf[4];
      if (std::fread(padbuf, 1, pad, f) != pad) {
        error = "truncated record padding";
        return -1;
      }
    }
    return 1;
  }

  // assemble one logical record (handles multipart). Same return codes.
  int Next() {
    record.clear();
    uint32_t cflag = 0;
    std::vector<uint8_t> chunk;
    int rc = ReadChunk(&cflag, &chunk);
    if (rc <= 0) return rc;
    if (cflag == 0) {
      record = std::move(chunk);
      return 1;
    }
    if (cflag != 1) {
      error = "unexpected continuation flag";
      return -1;
    }
    const uint8_t magic_bytes[4] = {0x0a, 0x23, 0xd7, 0xce};  // LE
    record = std::move(chunk);
    while (true) {
      rc = ReadChunk(&cflag, &chunk);
      if (rc <= 0) {
        error = "truncated multipart record";
        return -1;
      }
      record.insert(record.end(), magic_bytes, magic_bytes + 4);
      record.insert(record.end(), chunk.begin(), chunk.end());
      if (cflag == 3) return 1;
      if (cflag != 2) {
        error = "unexpected continuation flag";
        return -1;
      }
    }
  }
};

// Bounded-queue prefetcher: one producer thread reads ahead, consumers
// pop assembled records (the reference's iter_image_recordio_2.cc
// producer/consumer split).
struct Prefetcher {
  Reader reader;
  std::deque<std::vector<uint8_t>> queue;
  std::vector<uint8_t> current;     // last popped, owns consumer pointer
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  size_t capacity;
  bool done = false;
  bool failed = false;
  std::thread worker;

  Prefetcher(const char* path, int cap)
      : reader(path), capacity(cap > 0 ? cap : 64) {
    if (reader.f) worker = std::thread([this] { Run(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
      capacity = 1u << 30;          // release a blocked producer
    }
    not_full.notify_all();
    not_empty.notify_all();
    if (worker.joinable()) worker.join();
  }

  void Run() {
    while (true) {
      int rc = reader.Next();
      std::unique_lock<std::mutex> lk(mu);
      if (rc <= 0) {
        failed = (rc < 0);
        done = true;
        not_empty.notify_all();
        return;
      }
      not_full.wait(lk, [this] {
        return queue.size() < capacity || done;
      });
      if (done) return;
      queue.push_back(std::move(reader.record));
      not_empty.notify_one();
    }
  }

  // 1 record, 0 EOF, -1 error
  int Pop() {
    std::unique_lock<std::mutex> lk(mu);
    not_empty.wait(lk, [this] { return !queue.empty() || done; });
    if (queue.empty()) return failed ? -1 : 0;
    current = std::move(queue.front());
    queue.pop_front();
    not_full.notify_one();
    return 1;
  }
};

}  // namespace

extern "C" {

void* rio_open_reader(const char* path) {
  Reader* r = new Reader(path);
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

// >=0: record length (data -> internal buffer, valid until next call)
// -1: EOF, -2: error
long rio_read(void* h, const uint8_t** data) {
  Reader* r = static_cast<Reader*>(h);
  int rc = r->Next();
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  *data = r->record.data();
  return static_cast<long>(r->record.size());
}

// indexed access: seek then read one record (MXIndexedRecordIO.read_idx)
long rio_read_at(void* h, long pos, const uint8_t** data) {
  Reader* r = static_cast<Reader*>(h);
  if (std::fseek(r->f, pos, SEEK_SET) != 0) return -2;
  return rio_read(h, data);
}

void rio_seek(void* h, long pos) {
  Reader* r = static_cast<Reader*>(h);
  std::fseek(r->f, pos, SEEK_SET);
}

long rio_tell(void* h) {
  Reader* r = static_cast<Reader*>(h);
  return std::ftell(r->f);
}

const char* rio_error(void* h) {
  return static_cast<Reader*>(h)->error.c_str();
}

void rio_close(void* h) { delete static_cast<Reader*>(h); }

void* rio_open_prefetch(const char* path, int queue_size) {
  Prefetcher* p = new Prefetcher(path, queue_size);
  if (!p->reader.f) {
    delete p;
    return nullptr;
  }
  return p;
}

long rio_pf_read(void* h, const uint8_t** data) {
  Prefetcher* p = static_cast<Prefetcher*>(h);
  int rc = p->Pop();
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  *data = p->current.data();
  return static_cast<long>(p->current.size());
}

void rio_pf_close(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"
