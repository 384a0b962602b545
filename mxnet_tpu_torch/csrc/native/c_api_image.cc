// The C entry points of the port's image iterator, loaded by
// mxnet_tpu_torch/_core.py (image_lib) with ctypes: the MXTImageRecordIter*
// functions of src/c_api.cc (the JAX package's) and this library's own
// MXTGetLastError. Built by mxnet_tpu_torch/_build.py
// (native_image_library) with OpenCV 4, apart from the engine and
// RecordIO, which build without it.
#include <string>

#include "image_record_iter.h"

extern "C" {

static thread_local std::string last_error;
const char* MXTGetLastError() { return last_error.c_str(); }

#define API_BEGIN() try {
#define API_END()                     \
  }                                   \
  catch (const std::exception& e) {   \
    last_error = e.what();            \
    return -1;                        \
  }                                   \
  return 0;

// ---- image record iterator ---------------------------------------------
void* MXTImageRecordIterCreate(const char* rec_path, const char* idx_path,
                               int batch_size, int channels, int height,
                               int width, int label_width, int shuffle,
                               int rand_crop, int rand_mirror, int resize,
                               const float* mean, const float* stdv,
                               int num_parts, int part_index,
                               int num_threads, int prefetch,
                               uint64_t seed) {
  try {
    mxt_native::io::ImageRecordParam p;
    p.path_imgrec = rec_path;
    p.path_imgidx = idx_path;
    p.batch_size = batch_size;
    p.channels = channels;
    p.height = height;
    p.width = width;
    p.label_width = label_width;
    p.shuffle = shuffle != 0;
    p.rand_crop = rand_crop != 0;
    p.rand_mirror = rand_mirror != 0;
    p.resize = resize;
    for (int i = 0; i < 3; ++i) {
      p.mean[i] = mean ? mean[i] : 0.f;
      p.std_[i] = stdv ? stdv[i] : 1.f;
    }
    p.num_parts = num_parts;
    p.part_index = part_index;
    p.num_threads = num_threads;
    p.prefetch = prefetch;
    p.seed = seed;
    return new mxt_native::io::ImageRecordIter(p);
  } catch (const std::exception& e) {
    last_error = e.what();
    return nullptr;
  }
}

void MXTImageRecordIterFree(void* h) {
  delete static_cast<mxt_native::io::ImageRecordIter*>(h);
}

// Returns 1 with pointers set, 0 at epoch end, -1 on error.
int MXTImageRecordIterNext(void* h, const float** data,
                           const float** label, int* pad) {
  try {
    auto* it = static_cast<mxt_native::io::ImageRecordIter*>(h);
    if (!it->Next()) return 0;
    *data = it->data();
    *label = it->label();
    *pad = it->pad();
    return 1;
  } catch (const std::exception& e) {
    last_error = e.what();
    return -1;
  }
}

int MXTImageRecordIterReset(void* h) {
  API_BEGIN()
  static_cast<mxt_native::io::ImageRecordIter*>(h)->Reset();
  API_END()
}

}  // extern "C"
