// Native image-record pipeline: multithreaded JPEG decode + augment.
//
// Native analogue of the reference's C++ ImageRecordIter internals
// (reference: src/io/iter_image_recordio_2.cc:887 — worker threads doing
// cv::imdecode + augmentation into pre-allocated batch buffers). Design
// differences from the reference, on purpose:
//   - the .rec file is mmap'd once; workers read records at offsets the
//     Python side hands them per epoch (shuffle/sharding/padding policy
//     stays in Python where it is testable and mirrors the pure-Python
//     ImageIter exactly),
//   - per-sample RNG is seeded from (epoch_seed, sample_index), so the
//     produced batches are bit-identical regardless of thread count or
//     scheduling — a property the reference does not have,
//   - batches complete in order through a fixed ring of buffers; the
//     consumer copy-out is the only serialized step.
//
// C ABI (driven by mxnet_tpu_torch/image/native_iter.py via ctypes):
//   ip_create / ip_start_epoch / ip_next_batch / ip_error_count /
//   ip_last_error / ip_destroy

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr int kNumBuffers = 3;

#pragma pack(push, 1)
struct IRHeader {        // recordio.py IRHeader, struct fmt "IfQQ"
  uint32_t flag;         // >0: `flag` label floats follow the header
  float label;
  uint64_t id;
  uint64_t id2;
};
#pragma pack(pop)

struct Task {
  int64_t batch;     // epoch-global batch index
  int slot;          // position within the batch
  int64_t offset;    // record offset in the .rec file
  int64_t sample_index;  // epoch-global, for deterministic RNG
};

struct Pipe {
  // immutable config
  int batch, h, w, c;
  bool nhwc, rand_crop, rand_mirror;
  int resize_short;          // 0 = off
  int label_width;
  std::vector<float> mean, stdv;  // empty = no normalization

  // mmap'd record file
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;

  // epoch state (guarded by mu unless noted)
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::deque<Task> tasks;
  uint32_t epoch_seed = 0;
  int64_t nbatches = 0;
  int64_t batches_consumed = 0;   // consumer progress, gates the ring
  int64_t consume_idx = 0;
  std::vector<int> batch_count;   // samples in each batch
  std::vector<std::atomic<int>> remaining;  // per-buffer slots left
  std::vector<int64_t> ready_batch;         // per-buffer: ready batch id
  std::vector<std::vector<float>> buf_data;
  std::vector<std::vector<float>> buf_label;
  int active = 0;                 // workers currently inside a task
  bool shutdown = false;
  std::atomic<long> decode_errors{0};
  std::string last_error;
  std::string last_error_snapshot;  // stable buffer for ip_last_error

  std::vector<std::thread> workers;

  size_t SampleFloats() const { return size_t(h) * w * c; }

  bool Open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) { last_error = "cannot open rec file"; return false; }
    struct stat st;
    if (fstat(fd, &st) != 0) { last_error = "fstat failed"; return false; }
    file_size = st.st_size;
    base = static_cast<const uint8_t*>(
        mmap(nullptr, file_size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (base == MAP_FAILED) {
      base = nullptr;
      last_error = "mmap failed";
      return false;
    }
    return true;
  }

  ~Pipe() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
      tasks.clear();
    }
    cv_worker.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    if (base) munmap(const_cast<uint8_t*>(base), file_size);
    if (fd >= 0) ::close(fd);
  }

  // ---- record parsing ----------------------------------------------------
  // Returns payload span for the record at `off`, or false. Image records
  // are single-chunk (multipart starts at 512MB payloads).
  bool RecordAt(int64_t off, const uint8_t** payload, size_t* len) {
    if (off < 0 || size_t(off) + 8 > file_size) return false;
    uint32_t magic, lrec;
    std::memcpy(&magic, base + off, 4);
    std::memcpy(&lrec, base + off + 4, 4);
    if (magic != kMagic || (lrec >> 29) != 0) return false;
    size_t n = lrec & ((1u << 29) - 1);
    if (size_t(off) + 8 + n > file_size) return false;
    *payload = base + off + 8;
    *len = n;
    return true;
  }

  // ---- per-sample work ---------------------------------------------------
  void DecodeInto(const Task& t) {
    float* out = buf_data[t.batch % kNumBuffers].data() +
                 size_t(t.slot) * SampleFloats();
    float* lab = buf_label[t.batch % kNumBuffers].data() +
                 size_t(t.slot) * label_width;
    const uint8_t* payload;
    size_t len;
    const char* why = nullptr;
    bool ok = RecordAt(t.offset, &payload, &len);
    if (!ok) why = "bad record framing (magic/length/bounds)";
    IRHeader hdr{};
    size_t img_off = sizeof(IRHeader);
    if (ok && len >= sizeof(IRHeader)) {
      std::memcpy(&hdr, payload, sizeof(IRHeader));
      if (hdr.flag > 0) img_off += size_t(hdr.flag) * 4;
      if (img_off > len) { ok = false; why = "header flag overruns record"; }
    } else if (ok) {
      ok = false;
      why = "record shorter than IRHeader";
    }
    // labels: scalar from header, or hdr.flag floats after it
    for (int i = 0; i < label_width; ++i) lab[i] = 0.f;
    if (ok) {
      if (hdr.flag > 0) {
        int n = std::min<int>(label_width, hdr.flag);
        std::memcpy(lab, payload + sizeof(IRHeader), size_t(n) * 4);
      } else {
        lab[0] = hdr.label;
      }
    }

    cv::Mat img;
    if (ok) {
      cv::Mat raw(1, int(len - img_off), CV_8UC1,
                  const_cast<uint8_t*>(payload + img_off));
      img = cv::imdecode(raw, c == 1 ? cv::IMREAD_GRAYSCALE
                                     : cv::IMREAD_COLOR);
      ok = !img.empty();
      if (!ok) why = "image decode failed (corrupt or unsupported codec)";
    }
    if (!ok) {
      decode_errors.fetch_add(1, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lk(mu);
        last_error = "sample " + std::to_string(t.sample_index) +
                     " (rec offset " + std::to_string(t.offset) + "): " +
                     (why ? why : "unknown");
      }
      std::memset(out, 0, SampleFloats() * sizeof(float));
      return;
    }
    if (c == 3) cv::cvtColor(img, img, cv::COLOR_BGR2RGB);

    // deterministic per-sample RNG: independent of thread scheduling
    std::mt19937 rng(epoch_seed * 2654435761u +
                     uint32_t(t.sample_index) * 40503u + 1u);

    if (resize_short > 0) {
      int sh = img.rows, sw = img.cols;
      double scale = double(resize_short) / std::min(sh, sw);
      cv::resize(img, img,
                 cv::Size(std::max(1, int(sw * scale + 0.5)),
                          std::max(1, int(sh * scale + 0.5))),
                 0, 0, cv::INTER_LINEAR);
    }
    if (img.rows < h || img.cols < w) {
      cv::resize(img, img, cv::Size(w, h), 0, 0, cv::INTER_LINEAR);
    }
    int y0, x0;
    if (rand_crop) {
      y0 = img.rows == h ? 0 : int(rng() % uint32_t(img.rows - h + 1));
      x0 = img.cols == w ? 0 : int(rng() % uint32_t(img.cols - w + 1));
    } else {
      y0 = (img.rows - h) / 2;
      x0 = (img.cols - w) / 2;
    }
    cv::Mat crop = img(cv::Rect(x0, y0, w, h));
    bool mirror = rand_mirror && (rng() & 1u);

    const bool norm = !mean.empty();
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = crop.ptr<uint8_t>(y);
      for (int x = 0; x < w; ++x) {
        int xs = mirror ? (w - 1 - x) : x;
        for (int ch = 0; ch < c; ++ch) {
          float v = float(row[xs * c + ch]);
          if (norm) v = (v - mean[ch]) / stdv[ch];
          size_t dst = nhwc
              ? (size_t(y) * w + x) * c + ch
              : size_t(ch) * h * w + size_t(y) * w + x;
          out[dst] = v;
        }
      }
    }
  }

  // ---- worker loop -------------------------------------------------------
  void WorkerLoop() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [this] {
          return shutdown ||
                 (!tasks.empty() &&
                  tasks.front().batch - batches_consumed < kNumBuffers);
        });
        if (shutdown) return;
        t = tasks.front();
        tasks.pop_front();
        ++active;
      }
      DecodeInto(t);
      {
        std::unique_lock<std::mutex> lk(mu);
        --active;
        auto& rem = remaining[t.batch % kNumBuffers];
        if (rem.fetch_sub(1) == 1) {
          ready_batch[t.batch % kNumBuffers] = t.batch;
          cv_consumer.notify_all();
        }
        if (active == 0 && tasks.empty()) cv_consumer.notify_all();
      }
    }
  }

  // ---- epoch control -----------------------------------------------------
  void StartEpoch(const int64_t* offsets, int64_t n, uint32_t seed) {
    std::unique_lock<std::mutex> lk(mu);
    // abort any in-flight epoch: drop queued work, wait out active tasks
    tasks.clear();
    cv_consumer.wait(lk, [this] { return active == 0; });
    epoch_seed = seed;
    nbatches = (n + batch - 1) / batch;
    batches_consumed = 0;
    consume_idx = 0;
    batch_count.assign(nbatches, batch);
    if (n % batch) batch_count[nbatches - 1] = int(n % batch);
    for (int b = 0; b < kNumBuffers && b < nbatches; ++b)
      remaining[b].store(batch_count[b]);
    for (int b = 0; b < kNumBuffers; ++b) ready_batch[b] = -1;
    for (int64_t i = 0; i < n; ++i)
      tasks.push_back(Task{i / batch, int(i % batch), offsets[i], i});
    cv_worker.notify_all();
  }

  // returns sample count, 0 at epoch end, -1 on error
  long NextBatch(float* out_data, float* out_label) {
    std::unique_lock<std::mutex> lk(mu);
    if (consume_idx >= nbatches) return 0;
    int64_t b = consume_idx;
    cv_consumer.wait(lk, [this, b] {
      return shutdown || ready_batch[b % kNumBuffers] == b;
    });
    if (shutdown) return -1;
    int count = batch_count[b];
    // The buffer is exclusively ours once ready: drop the lock for the
    // ~100MB copy-out so finishing workers don't stall behind it.
    lk.unlock();
    std::memcpy(out_data, buf_data[b % kNumBuffers].data(),
                size_t(count) * SampleFloats() * sizeof(float));
    std::memcpy(out_label, buf_label[b % kNumBuffers].data(),
                size_t(count) * label_width * sizeof(float));
    lk.lock();
    // recycle the buffer for batch b + kNumBuffers
    ready_batch[b % kNumBuffers] = -1;
    if (b + kNumBuffers < nbatches)
      remaining[b % kNumBuffers].store(batch_count[b + kNumBuffers]);
    ++consume_idx;
    ++batches_consumed;
    cv_worker.notify_all();
    return count;
  }
};

}  // namespace

extern "C" {

void* ip_create(const char* rec_path, int batch, int h, int w, int c,
                int nthreads, int nhwc, int resize_short, int rand_crop,
                int rand_mirror, const float* mean, const float* stdv,
                int label_width) {
  Pipe* p = new Pipe();
  p->batch = batch;
  p->h = h;
  p->w = w;
  p->c = c;
  p->nhwc = nhwc != 0;
  p->resize_short = resize_short;
  p->rand_crop = rand_crop != 0;
  p->rand_mirror = rand_mirror != 0;
  p->label_width = label_width > 0 ? label_width : 1;
  if (mean && stdv) {
    p->mean.assign(mean, mean + c);
    p->stdv.assign(stdv, stdv + c);
  }
  if (!p->Open(rec_path)) {
    delete p;
    return nullptr;
  }
  p->buf_data.resize(kNumBuffers);
  p->buf_label.resize(kNumBuffers);
  for (int i = 0; i < kNumBuffers; ++i) {
    p->buf_data[i].resize(size_t(batch) * p->SampleFloats());
    p->buf_label[i].resize(size_t(batch) * p->label_width);
  }
  p->remaining = std::vector<std::atomic<int>>(kNumBuffers);
  p->ready_batch.assign(kNumBuffers, -1);
  if (nthreads < 1) nthreads = 1;
  for (int i = 0; i < nthreads; ++i)
    p->workers.emplace_back([p] { p->WorkerLoop(); });
  return p;
}

void ip_start_epoch(void* h, const int64_t* offsets, int64_t n,
                    uint32_t seed) {
  static_cast<Pipe*>(h)->StartEpoch(offsets, n, seed);
}

long ip_next_batch(void* h, float* out_data, float* out_label) {
  return static_cast<Pipe*>(h)->NextBatch(out_data, out_label);
}

long ip_error_count(void* h) {
  return static_cast<Pipe*>(h)->decode_errors.load();
}

const char* ip_last_error(void* h) {
  // workers update last_error under mu; snapshot it under the same lock
  // so the returned pointer stays stable for the (single-threaded)
  // ctypes caller even while decode threads keep failing
  Pipe* p = static_cast<Pipe*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  p->last_error_snapshot = p->last_error;
  return p->last_error_snapshot.c_str();
}

void ip_destroy(void* h) { delete static_cast<Pipe*>(h); }

}  // extern "C"
