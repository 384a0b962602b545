// The C entry points of the port's native runtime, loaded by
// mxnet_tpu_torch/_core.py with ctypes: the engine, RecordIO and
// MXTGetLastError of src/c_api.cc (the JAX package's), with the same MXT*
// names. Built by mxnet_tpu_torch/_build.py (native_library) with the host
// C++ compiler; the image iterator's entries are c_api_image.cc, in a
// library of their own, since only they need OpenCV.
#include <cstring>
#include <string>

#include "engine.h"
#include "recordio.h"

extern "C" {

// ---- error handling (reference c_api_common.h API_BEGIN/END) ----------
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

// ---- engine ------------------------------------------------------------
typedef void (*MXTOpCallback)(void* payload);

void* MXTEngineCreate(int num_workers) {
  return new mxt_native::engine::ThreadedEngine(num_workers);
}

void MXTEngineFree(void* h) {
  delete static_cast<mxt_native::engine::ThreadedEngine*>(h);
}

int64_t MXTEngineNewVar(void* h) {
  return static_cast<mxt_native::engine::ThreadedEngine*>(h)->NewVariable();
}

int MXTEnginePush(void* h, MXTOpCallback cb, void* payload,
                  const int64_t* const_vars, int n_const,
                  const int64_t* mutable_vars, int n_mut) {
  API_BEGIN()
  auto* eng = static_cast<mxt_native::engine::ThreadedEngine*>(h);
  std::vector<int64_t> cv(const_vars, const_vars + n_const);
  std::vector<int64_t> mv(mutable_vars, mutable_vars + n_mut);
  eng->Push([cb, payload] { cb(payload); }, cv, mv);
  API_END()
}

int MXTEngineWaitForVar(void* h, int64_t var) {
  API_BEGIN()
  static_cast<mxt_native::engine::ThreadedEngine*>(h)->WaitForVar(var);
  API_END()
}

int MXTEngineWaitAll(void* h) {
  API_BEGIN()
  static_cast<mxt_native::engine::ThreadedEngine*>(h)->WaitForAll();
  API_END()
}

int MXTEngineDeleteVar(void* h, int64_t var) {
  API_BEGIN()
  static_cast<mxt_native::engine::ThreadedEngine*>(h)->DeleteVariable(var);
  API_END()
}

// ---- recordio ----------------------------------------------------------
// Reader handle owns its record buffer so returned pointers stay valid
// until the next call on the SAME reader (not just the same thread).
struct MXTReaderHandle {
  explicit MXTReaderHandle(const char* path) : reader(path) {}
  mxt_native::io::RecordReader reader;
  std::string buf;
};

void* MXTRecordReaderCreate(const char* path) {
  try {
    return new MXTReaderHandle(path);
  } catch (const std::exception& e) {
    last_error = e.what();
    return nullptr;
  }
}

void MXTRecordReaderFree(void* h) {
  delete static_cast<MXTReaderHandle*>(h);
}

// Returns 1 if a record was read, 0 at EOF, -1 on error.  The pointer
// is valid until the next call on this reader.
int MXTRecordReaderNext(void* h, const char** data, uint64_t* size) {
  try {
    auto* r = static_cast<MXTReaderHandle*>(h);
    if (!r->reader.Next(&r->buf)) return 0;
    *data = r->buf.data();
    *size = r->buf.size();
    return 1;
  } catch (const std::exception& e) {
    last_error = e.what();
    return -1;
  }
}

int MXTRecordReaderSeek(void* h, uint64_t pos) {
  API_BEGIN()
  static_cast<MXTReaderHandle*>(h)->reader.Seek(pos);
  API_END()
}

void* MXTRecordWriterCreate(const char* path) {
  try {
    return new mxt_native::io::RecordWriter(path);
  } catch (const std::exception& e) {
    last_error = e.what();
    return nullptr;
  }
}

void MXTRecordWriterFree(void* h) {
  delete static_cast<mxt_native::io::RecordWriter*>(h);
}

int64_t MXTRecordWriterWrite(void* h, const char* data, uint64_t size) {
  try {
    return static_cast<int64_t>(
        static_cast<mxt_native::io::RecordWriter*>(h)->Write(data, size));
  } catch (const std::exception& e) {
    last_error = e.what();
    return -1;
  }
}

}  // extern "C"
