// The C predict API of the PyTorch port: create a predictor from a
// symbol JSON string and a param blob, set inputs, forward, read outputs,
// from any language with a C FFI and no Python in the caller. The
// counterpart of src/c_predict_api.cc (the JAX package's), with the same
// MXTPred* / MXTNDList* symbols.
//
// The library hosts an embedded CPython interpreter (brought up at the
// first MXTPredCreate or MXTNDListCreate; nothing to do when it is loaded
// inside a Python process) and drives mxnet_tpu_torch/_c_predict_bridge.py
// through a str/bytes/int call surface. A handle caches its shape and
// output buffers on the C++ side, so a returned pointer stays valid until
// the next call on the same handle. dev_type 1 is the CPU, 2 the card;
// any other value fails MXTPredCreate, and so does 2 on a host without
// CUDA.
//
// Built by mxnet_tpu_torch/_build.py (c_predict_library) with the host
// C++ compiler against the building interpreter's headers and libpython.
#include "py_embed.h"

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string pred_last_error;

using pyembed::GIL;

std::string py_err_string() { return pyembed::err_string(); }

bool ensure_python() {
  return pyembed::ensure_interpreter(&pred_last_error);
}

PyObject* bridge_module() {
  PyObject* mod =
      PyImport_ImportModule("mxnet_tpu_torch._c_predict_bridge");
  if (mod == nullptr) pred_last_error = py_err_string();
  return mod;
}

struct PredHandle {
  PyObject* obj = nullptr;                       // bridge Predictor
  std::vector<std::vector<uint32_t>> shapes;     // per-output shape cache
  std::string out_buf;                           // last GetOutput bytes
};

struct NDListHandle {
  std::vector<std::string> keys;
  std::vector<std::vector<uint32_t>> shapes;
  std::vector<std::string> data;                 // float32 bytes
};

// Build the [(key, (shape...)), ...] argument pair for create/reshape.
PyObject* shapes_to_pylist(uint32_t num, const uint32_t* indptr,
                           const uint32_t* shape_data) {
  PyObject* list = PyList_New(num);
  if (list == nullptr) return nullptr;
  for (uint32_t i = 0; i < num; ++i) {
    uint32_t lo = indptr[i], hi = indptr[i + 1];
    PyObject* tup = PyTuple_New(hi - lo);
    if (tup == nullptr) {
      Py_DECREF(list);
      return nullptr;
    }
    for (uint32_t j = lo; j < hi; ++j)
      PyTuple_SET_ITEM(tup, j - lo, PyLong_FromLong(shape_data[j]));
    PyList_SET_ITEM(list, i, tup);
  }
  return list;
}

PyObject* keys_to_pylist(uint32_t num, const char** keys) {
  PyObject* list = PyList_New(num);
  if (list == nullptr) return nullptr;
  for (uint32_t i = 0; i < num; ++i)
    PyList_SET_ITEM(list, i, PyUnicode_FromString(keys[i]));
  return list;
}

bool fill_shape(PyObject* tup, std::vector<uint32_t>* out) {
  if (!PyTuple_Check(tup)) return false;
  Py_ssize_t n = PyTuple_GET_SIZE(tup);
  out->resize(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    (*out)[i] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GET_ITEM(tup, i)));
  return !PyErr_Occurred();
}

int create_impl(const char* symbol_json, const void* param_bytes,
                int param_size, int dev_type, int dev_id,
                uint32_t num_input_nodes, const char** input_keys,
                const uint32_t* input_shape_indptr,
                const uint32_t* input_shape_data,
                uint32_t num_output_nodes, const char** output_keys,
                void** out) {
  *out = nullptr;
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* keys = keys_to_pylist(num_input_nodes, input_keys);
  PyObject* shapes = shapes_to_pylist(num_input_nodes, input_shape_indptr,
                                      input_shape_data);
  PyObject* outs = num_output_nodes
      ? keys_to_pylist(num_output_nodes, output_keys)
      : (Py_INCREF(Py_None), Py_None);
  PyObject* pred = nullptr;
  if (keys != nullptr && shapes != nullptr && outs != nullptr) {
    pred = PyObject_CallMethod(
        mod, "create", "sy#iiOOO", symbol_json,
        static_cast<const char*>(param_bytes),
        static_cast<Py_ssize_t>(param_size), dev_type, dev_id, keys,
        shapes, outs);
  }
  Py_XDECREF(keys);
  Py_XDECREF(shapes);
  Py_XDECREF(outs);
  Py_DECREF(mod);
  if (pred == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  PredHandle* h = new PredHandle();
  h->obj = pred;
  *out = h;
  return 0;
}

}  // namespace

extern "C" {

// Mirrors reference c_predict_api.h MXPredCreate.  dev_type: 1 = cpu,
// 2 = gpu (the card).  Shapes arrive CSR-style: input i owns
// shape_data[indptr[i]:indptr[i+1]].
int MXTPredCreate(const char* symbol_json, const void* param_bytes,
                  int param_size, int dev_type, int dev_id,
                  uint32_t num_input_nodes, const char** input_keys,
                  const uint32_t* input_shape_indptr,
                  const uint32_t* input_shape_data, void** out) {
  return create_impl(symbol_json, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys,
                     input_shape_indptr, input_shape_data, 0, nullptr,
                     out);
}

// Reference MXPredCreatePartialOut: expose internal nodes as outputs.
int MXTPredCreatePartialOut(const char* symbol_json,
                            const void* param_bytes, int param_size,
                            int dev_type, int dev_id,
                            uint32_t num_input_nodes,
                            const char** input_keys,
                            const uint32_t* input_shape_indptr,
                            const uint32_t* input_shape_data,
                            uint32_t num_output_nodes,
                            const char** output_keys, void** out) {
  return create_impl(symbol_json, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys,
                     input_shape_indptr, input_shape_data,
                     num_output_nodes, output_keys, out);
}

int MXTPredGetOutputShape(void* handle, uint32_t index,
                          const uint32_t** shape_data,
                          uint32_t* shape_ndim) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* tup = PyObject_CallMethod(mod, "get_output_shape", "OI",
                                      h->obj, index);
  Py_DECREF(mod);
  if (tup == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  if (h->shapes.size() <= index) h->shapes.resize(index + 1);
  bool ok = fill_shape(tup, &h->shapes[index]);
  Py_DECREF(tup);
  if (!ok) {
    pred_last_error = py_err_string();
    return -1;
  }
  *shape_data = h->shapes[index].data();
  *shape_ndim = static_cast<uint32_t>(h->shapes[index].size());
  return 0;
}

int MXTPredSetInput(void* handle, const char* key, const float* data,
                    uint32_t size) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* r = PyObject_CallMethod(
      mod, "set_input", "Osy#", h->obj, key,
      reinterpret_cast<const char*>(data),
      static_cast<Py_ssize_t>(size * sizeof(float)));
  Py_DECREF(mod);
  if (r == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXTPredForward(void* handle) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* r = PyObject_CallMethod(mod, "forward", "O", h->obj);
  Py_DECREF(mod);
  if (r == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Reference MXPredPartialForward (graph_executor.cc:54): run the first
// `step` op nodes; *step_left reports how many remain.
int MXTPredPartialForward(void* handle, int step, int* step_left) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* r = PyObject_CallMethod(mod, "partial_forward", "Oi",
                                    h->obj, step);
  Py_DECREF(mod);
  if (r == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  *step_left = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTPredGetOutput(void* handle, uint32_t index, float* data,
                     uint32_t size) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* r = PyObject_CallMethod(mod, "get_output", "OI", h->obj,
                                    index);
  Py_DECREF(mod);
  if (r == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    pred_last_error = py_err_string();
    return -1;
  }
  if (static_cast<uint64_t>(len) != uint64_t{size} * sizeof(float)) {
    Py_DECREF(r);
    pred_last_error = "MXTPredGetOutput: caller buffer holds " +
                      std::to_string(size) + " floats, output has " +
                      std::to_string(len / sizeof(float));
    return -1;
  }
  std::memcpy(data, buf, len);
  Py_DECREF(r);
  return 0;
}

// Reference MXPredReshape (in place here: same handle, new shapes).
int MXTPredReshape(void* handle, uint32_t num_input_nodes,
                   const char** input_keys,
                   const uint32_t* input_shape_indptr,
                   const uint32_t* input_shape_data) {
  auto* h = static_cast<PredHandle*>(handle);
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* keys = keys_to_pylist(num_input_nodes, input_keys);
  PyObject* shapes = shapes_to_pylist(num_input_nodes,
                                      input_shape_indptr,
                                      input_shape_data);
  PyObject* r = nullptr;
  if (keys != nullptr && shapes != nullptr)
    r = PyObject_CallMethod(mod, "reshape", "OOO", h->obj, keys, shapes);
  Py_XDECREF(keys);
  Py_XDECREF(shapes);
  Py_DECREF(mod);
  if (r == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

void MXTPredFree(void* handle) {
  auto* h = static_cast<PredHandle*>(handle);
  if (h == nullptr) return;
  if (Py_IsInitialized()) {
    GIL gil;
    Py_XDECREF(h->obj);
  }
  delete h;
}

// ---- NDArray list (reference MXNDListCreate/Get/Free) -----------------
// Parse a .params blob into named float32 arrays — lets C callers read
// mean/std blobs and checkpoints without the full framework.
int MXTNDListCreate(const char* nd_file_bytes, int size, void** out,
                    uint32_t* out_length) {
  *out = nullptr;
  if (!ensure_python()) return -1;
  GIL gil;
  PyObject* mod = bridge_module();
  if (mod == nullptr) return -1;
  PyObject* lst = PyObject_CallMethod(
      mod, "ndlist_create", "y#", nd_file_bytes,
      static_cast<Py_ssize_t>(size));
  Py_DECREF(mod);
  if (lst == nullptr) {
    pred_last_error = py_err_string();
    return -1;
  }
  NDListHandle* h = new NDListHandle();
  Py_ssize_t n = PyList_Size(lst);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GetItem(lst, i);  // (name, shape, bytes)
    const char* name = PyUnicode_AsUTF8(PyTuple_GetItem(item, 0));
    std::vector<uint32_t> shape;
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (name == nullptr ||
        !fill_shape(PyTuple_GetItem(item, 1), &shape) ||
        PyBytes_AsStringAndSize(PyTuple_GetItem(item, 2), &buf, &len)
            != 0) {
      pred_last_error = py_err_string();
      Py_DECREF(lst);
      delete h;
      return -1;
    }
    h->keys.emplace_back(name);
    h->shapes.push_back(std::move(shape));
    h->data.emplace_back(buf, len);
  }
  Py_DECREF(lst);
  *out_length = static_cast<uint32_t>(h->keys.size());
  *out = h;
  return 0;
}

int MXTNDListGet(void* handle, uint32_t index, const char** out_key,
                 const float** out_data, const uint32_t** out_shape,
                 uint32_t* out_ndim) {
  auto* h = static_cast<NDListHandle*>(handle);
  if (index >= h->keys.size()) {
    pred_last_error = "MXTNDListGet: index out of range";
    return -1;
  }
  *out_key = h->keys[index].c_str();
  *out_data = reinterpret_cast<const float*>(h->data[index].data());
  *out_shape = h->shapes[index].data();
  *out_ndim = static_cast<uint32_t>(h->shapes[index].size());
  return 0;
}

void MXTNDListFree(void* handle) {
  delete static_cast<NDListHandle*>(handle);
}

// The last error of this thread's predict calls.
const char* MXTPredGetLastError() { return pred_last_error.c_str(); }

}  // extern "C"
