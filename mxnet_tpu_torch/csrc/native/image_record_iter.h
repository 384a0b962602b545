// Multithreaded RecordIO image iterator of the port's native runtime, the
// counterpart of src/io/image_record_iter.h (the JAX package's) after the
// reference's iter_image_recordio_2.cc: one producer thread walks the
// (sharded, optionally shuffled) index and reads the records, a pool of
// decode workers runs OpenCV decode + augmentation straight into
// preallocated batch buffers, and a bounded ready-queue hands finished
// batches to the consumer. The batches are host float32 (NCHW); the
// Python side moves them to the card.
//
// Two departures from the JAX copy:
// - The in-flight batches are members (`inflight_`), not the producer's
//   locals, and are freed only after every thread has been joined. In the
//   JAX copy the producer freed them on its way out of a stopped epoch
//   while a worker could still be decoding into one (a use-after-free in
//   Reset() and the destructor).
// - A record that fails to decode fails the iterator: the next Next()
//   throws its message, as a failure of the producer does. The JAX copy
//   prints it and leaves the slot zero.
#ifndef MXT_NATIVE_IMAGE_RECORD_ITER_H_
#define MXT_NATIVE_IMAGE_RECORD_ITER_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace mxt_native {
namespace io {

struct ImageRecordParam {
  std::string path_imgrec;
  std::string path_imgidx;
  int batch_size = 1;
  int channels = 3;
  int height = 224;
  int width = 224;
  int label_width = 1;
  bool shuffle = false;
  bool rand_crop = false;
  bool rand_mirror = false;
  int resize = 0;  // resize shorter side first if > 0
  float mean[3] = {0.f, 0.f, 0.f};
  float std_[3] = {1.f, 1.f, 1.f};
  int num_parts = 1;
  int part_index = 0;
  int num_threads = 4;
  int prefetch = 4;  // ready-batch queue depth
  uint64_t seed = 0;
  bool round_batch = true;  // wrap the last partial batch
};

class ImageRecordIter {
 public:
  explicit ImageRecordIter(const ImageRecordParam& p);
  ~ImageRecordIter();

  // Advance to the next batch. Returns false at epoch end; throws if the
  // producer or a decode worker failed.
  bool Next();
  const float* data() const { return current_->data.data(); }
  const float* label() const { return current_->label.data(); }
  int pad() const { return current_->pad; }
  // Stop this epoch (joining every thread) and start the next.
  void Reset();
  size_t data_size() const;
  size_t label_size() const;

 private:
  struct Batch {
    std::vector<float> data;
    std::vector<float> label;
    int pad = 0;
    std::atomic<int> remaining{0};
  };
  struct Task {
    std::string raw;
    Batch* batch;
    int slot;
    uint64_t rng_seed;
  };

  void ProducerLoop(uint64_t epoch_seed);
  void ProducerBody(uint64_t epoch_seed);
  void WorkerLoop();
  void DecodeInto(const Task& t);
  void Fail(const std::string& what);
  void StartThreads();
  void StopThreads();

  ImageRecordParam p_;
  std::vector<uint64_t> offsets_;  // sharded record offsets

  // decode task queue
  std::deque<Task> tasks_;
  std::mutex task_mu_;
  std::condition_variable task_cv_;

  // batches handed to the workers, in order; only the producer touches
  // the deque while the threads run, and StopThreads frees it after
  // joining them
  std::deque<std::unique_ptr<Batch>> inflight_;

  // ready batches
  std::deque<std::unique_ptr<Batch>> ready_;
  std::mutex ready_mu_;
  std::condition_variable ready_cv_, space_cv_;
  int batches_consumed_ = 0;
  int batches_per_epoch_ = 0;

  std::unique_ptr<Batch> current_;
  std::vector<std::thread> workers_;
  std::thread producer_;
  std::atomic<bool> stop_{false};
  std::atomic<bool> failed_{false};
  std::string error_;  // guarded by ready_mu_
  uint64_t epoch_ = 0;
};

}  // namespace io
}  // namespace mxt_native

#endif  // MXT_NATIVE_IMAGE_RECORD_ITER_H_
