// ImageRecordIter (see image_record_iter.h). The decode path, the seeds
// and the order of the records are those of src/io/image_record_iter.cc,
// so that on the same OpenCV the two iterators give the same bits.
#include "image_record_iter.h"

#include <algorithm>
#include <cstring>
#include <fstream>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include "logging.h"
#include "recordio.h"

namespace mxt_native {
namespace io {

ImageRecordIter::ImageRecordIter(const ImageRecordParam& p) : p_(p) {
  if (p_.prefetch < 1) p_.prefetch = 1;  // 0 would deadlock the bound
  if (p_.batch_size < 1) p_.batch_size = 1;
  // load .idx offsets (key \t offset per line)
  std::ifstream fin(p_.path_imgidx);
  MXT_CHECK(fin.good()) << "cannot open idx " << p_.path_imgidx;
  std::vector<uint64_t> all;
  int64_t key;
  uint64_t off;
  while (fin >> key >> off) all.push_back(off);
  MXT_CHECK(!all.empty()) << "empty index " << p_.path_imgidx;
  // shard (reference dist-aware num_parts/part_index)
  if (p_.num_parts > 1) {
    MXT_CHECK(p_.part_index >= 0 && p_.part_index < p_.num_parts)
        << "part_index " << p_.part_index << " out of " << p_.num_parts;
    size_t per = all.size() / p_.num_parts;
    MXT_CHECK_GT(per, 0u) << "fewer records than parts";
    size_t begin = per * p_.part_index;
    size_t end = (p_.part_index == p_.num_parts - 1) ? all.size()
                                                     : begin + per;
    offsets_.assign(all.begin() + begin, all.begin() + end);
  } else {
    offsets_ = std::move(all);
  }
  int n = static_cast<int>(offsets_.size());
  batches_per_epoch_ = p_.round_batch
                           ? (n + p_.batch_size - 1) / p_.batch_size
                           : n / p_.batch_size;
  MXT_CHECK_GT(batches_per_epoch_, 0) << "not enough records for a batch";
  StartThreads();
}

ImageRecordIter::~ImageRecordIter() { StopThreads(); }

void ImageRecordIter::StartThreads() {
  for (int i = 0; i < std::max(1, p_.num_threads); ++i) {
    workers_.emplace_back([this] { WorkerLoop(); });
  }
  uint64_t seed = p_.seed + 0x9e3779b97f4a7c15ULL * (++epoch_);
  producer_ = std::thread([this, seed] { ProducerLoop(seed); });
}

void ImageRecordIter::StopThreads() {
  // stop_ is set under each queue's mutex, so a thread that has checked
  // its wait predicate but not yet blocked cannot miss the notify
  {
    std::lock_guard<std::mutex> lk(task_mu_);
    stop_.store(true);
  }
  { std::lock_guard<std::mutex> lk(ready_mu_); }
  task_cv_.notify_all();
  ready_cv_.notify_all();
  space_cv_.notify_all();
  for (auto& w : workers_) {
    if (w.joinable()) w.join();
  }
  workers_.clear();
  if (producer_.joinable()) producer_.join();
  // no thread is left that could hold a Task's batch pointer
  tasks_.clear();
  inflight_.clear();
  ready_.clear();
}

size_t ImageRecordIter::data_size() const {
  return static_cast<size_t>(p_.batch_size) * p_.channels * p_.height *
         p_.width;
}

size_t ImageRecordIter::label_size() const {
  return static_cast<size_t>(p_.batch_size) * p_.label_width;
}

void ImageRecordIter::Fail(const std::string& what) {
  {
    std::lock_guard<std::mutex> lk(ready_mu_);
    if (!failed_.load()) {
      error_ = what;
      failed_.store(true);
    }
  }
  ready_cv_.notify_all();
}

void ImageRecordIter::ProducerLoop(uint64_t epoch_seed) {
  // exceptions must not escape the thread (std::terminate): capture
  // and surface through Next()
  try {
    ProducerBody(epoch_seed);
  } catch (const std::exception& e) {
    Fail(e.what());
  }
}

void ImageRecordIter::ProducerBody(uint64_t epoch_seed) {
  std::vector<uint64_t> order = offsets_;
  if (p_.shuffle) {
    std::mt19937_64 rng(epoch_seed);
    std::shuffle(order.begin(), order.end(), rng);
  }
  RecordReader reader(p_.path_imgrec);
  int n = static_cast<int>(order.size());
  // keep several batches' decode tasks in flight so the worker pool is
  // never idle across batch boundaries; emit completed batches in order
  const int max_inflight = std::max(2, p_.prefetch);

  auto emit_front = [&]() -> bool {  // false on stop or failure
    Batch* bp = inflight_.front().get();
    std::unique_lock<std::mutex> lk(ready_mu_);
    ready_cv_.wait(lk, [&] {
      return stop_.load() || failed_.load() || bp->remaining.load() == 0;
    });
    if (stop_.load() || failed_.load()) return false;
    space_cv_.wait(lk, [&] {
      return stop_.load() ||
             static_cast<int>(ready_.size()) < p_.prefetch;
    });
    if (stop_.load()) return false;
    ready_.push_back(std::move(inflight_.front()));
    inflight_.pop_front();
    lk.unlock();
    ready_cv_.notify_all();
    return true;
  };

  for (int b = 0; b < batches_per_epoch_ && !stop_.load(); ++b) {
    auto batch = std::unique_ptr<Batch>(new Batch());
    batch->data.resize(data_size());
    batch->label.assign(label_size(), 0.f);
    int start = b * p_.batch_size;
    int real = std::min(p_.batch_size, n - start);
    batch->pad = p_.batch_size - real;
    batch->remaining.store(p_.batch_size);
    Batch* bp = batch.get();
    inflight_.push_back(std::move(batch));
    // reads are sequential (cheap); decode runs on the pool
    for (int i = 0; i < p_.batch_size; ++i) {
      int idx = (start + i) % n;  // wrap for the padded tail
      std::string raw;
      reader.Seek(order[idx]);
      MXT_CHECK(reader.Next(&raw)) << "record read failed";
      Task t;
      t.raw = std::move(raw);
      t.batch = bp;
      t.slot = i;
      t.rng_seed = epoch_seed ^ (0x853c49e6748fea9bULL *
                                 (uint64_t)(start + i + 1));
      {
        std::unique_lock<std::mutex> lk(task_mu_);
        tasks_.push_back(std::move(t));
      }
      task_cv_.notify_one();
    }
    if (static_cast<int>(inflight_.size()) >= max_inflight) {
      if (!emit_front()) return;
    }
  }
  while (!inflight_.empty()) {
    if (!emit_front()) return;
  }
}

void ImageRecordIter::WorkerLoop() {
  for (;;) {
    Task t;
    {
      std::unique_lock<std::mutex> lk(task_mu_);
      task_cv_.wait(lk, [this] { return stop_.load() || !tasks_.empty(); });
      if (stop_.load()) return;
      t = std::move(tasks_.front());
      tasks_.pop_front();
    }
    try {
      DecodeInto(t);
    } catch (const std::exception& e) {
      Fail(std::string("decode failed: ") + e.what());
    }
    if (t.batch->remaining.fetch_sub(1) == 1) {
      // batch complete — wake the producer
      std::lock_guard<std::mutex> lk(ready_mu_);
      ready_cv_.notify_all();
    }
  }
}

void ImageRecordIter::DecodeInto(const Task& t) {
  MXT_CHECK_GE(t.raw.size(), sizeof(IRHeader)) << "record shorter than "
                                                  "its header";
  const IRHeader* hdr =
      reinterpret_cast<const IRHeader*>(t.raw.data());
  const char* payload = t.raw.data() + sizeof(IRHeader);
  size_t payload_len = t.raw.size() - sizeof(IRHeader);
  // labels: flag>0 means flag floats prepended (recordio.py pack)
  float* lab = t.batch->label.data() +
               static_cast<size_t>(t.slot) * p_.label_width;
  if (hdr->flag > 0) {
    MXT_CHECK_GE(payload_len, static_cast<size_t>(hdr->flag) * 4)
        << "record shorter than its labels";
    const float* labels = reinterpret_cast<const float*>(payload);
    int nl = std::min<int>(hdr->flag, p_.label_width);
    for (int i = 0; i < nl; ++i) lab[i] = labels[i];
    payload += hdr->flag * 4;
    payload_len -= hdr->flag * 4;
  } else {
    lab[0] = hdr->label;
  }
  cv::Mat buf(1, static_cast<int>(payload_len), CV_8U,
              const_cast<char*>(payload));
  cv::Mat img = cv::imdecode(buf, p_.channels == 1 ? cv::IMREAD_GRAYSCALE
                                                   : cv::IMREAD_COLOR);
  MXT_CHECK(!img.empty()) << "imdecode failed";
  if (p_.channels == 3) cv::cvtColor(img, img, cv::COLOR_BGR2RGB);

  std::mt19937_64 rng(t.rng_seed);
  // resize shorter side
  if (p_.resize > 0) {
    int h = img.rows, w = img.cols;
    int nh, nw;
    if (h > w) {
      nw = p_.resize;
      nh = p_.resize * h / w;
    } else {
      nh = p_.resize;
      nw = p_.resize * w / h;
    }
    cv::resize(img, img, cv::Size(nw, nh), 0, 0, cv::INTER_AREA);
  }
  // crop to (H, W): random or center; upscale first if too small
  if (img.rows < p_.height || img.cols < p_.width) {
    cv::resize(img, img,
               cv::Size(std::max(img.cols, p_.width),
                        std::max(img.rows, p_.height)),
               0, 0, cv::INTER_LINEAR);
  }
  int y0, x0;
  if (p_.rand_crop) {
    y0 = static_cast<int>(rng() % (img.rows - p_.height + 1));
    x0 = static_cast<int>(rng() % (img.cols - p_.width + 1));
  } else {
    y0 = (img.rows - p_.height) / 2;
    x0 = (img.cols - p_.width) / 2;
  }
  cv::Mat crop = img(cv::Rect(x0, y0, p_.width, p_.height));
  bool mirror = p_.rand_mirror && (rng() & 1);
  if (mirror) cv::flip(crop, crop, 1);

  // cast + normalize + HWC->CHW into the batch slot
  float* out = t.batch->data.data() +
               static_cast<size_t>(t.slot) * p_.channels * p_.height *
                   p_.width;
  const size_t plane = static_cast<size_t>(p_.height) * p_.width;
  for (int y = 0; y < p_.height; ++y) {
    const uint8_t* row = crop.ptr<uint8_t>(y);
    for (int x = 0; x < p_.width; ++x) {
      for (int c = 0; c < p_.channels; ++c) {
        float v = static_cast<float>(row[x * p_.channels + c]);
        out[c * plane + y * p_.width + x] =
            (v - p_.mean[c]) / p_.std_[c];
      }
    }
  }
}

bool ImageRecordIter::Next() {
  std::unique_lock<std::mutex> lk(ready_mu_);
  if (failed_.load()) throw Error(error_);
  if (batches_consumed_ >= batches_per_epoch_) return false;
  ready_cv_.wait(lk, [this] {
    return stop_.load() || failed_.load() || !ready_.empty();
  });
  if (failed_.load()) throw Error(error_);
  if (ready_.empty()) return false;
  current_ = std::move(ready_.front());
  ready_.pop_front();
  ++batches_consumed_;
  lk.unlock();
  space_cv_.notify_all();
  return true;
}

void ImageRecordIter::Reset() {
  // stop + join everything, free the epoch's batches, start the next
  StopThreads();
  current_.reset();
  batches_consumed_ = 0;
  stop_.store(false);
  failed_.store(false);
  error_.clear();
  StartThreads();
}

}  // namespace io
}  // namespace mxt_native
