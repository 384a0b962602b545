// The training C API of the PyTorch port: NDArray / Symbol / Executor /
// KVStore / DataIter from plain C, the counterpart of src/c_api_train.cc
// (the JAX package's) with the same MXT* symbols. It is the surface a
// language binding needs to train, not only to predict: create NDArrays,
// compose symbols, simple_bind an executor, forward / backward, run an
// optimizer step, feed batches from a data iterator, talk to a kvstore
// (the reference's cpp-package trains an MLP on exactly this surface).
//
// Like c_predict_api.cc, it embeds CPython: each C call takes the GIL and
// drives mxnet_tpu_torch/_c_api_bridge.py; the opaque handles returned to
// C are PyObject* (NDArray / Symbol / Executor / KVStore / updater /
// iterator). String and shape lists returned to C are cached per handle
// and stay valid until the next call on the same handle. dev_type 1 is
// the CPU, 2 the card; the bridge refuses any other value. A Python
// error inside a call, a CUDA error among them, comes back as a nonzero
// return with MXTTrainGetLastError set.
//
// Threading contract: entry points are callable from any thread (each
// takes the GIL), but a handle is single-caller: per-handle caches and
// handle state are mutated without a lock, so concurrent calls on the
// SAME handle are undefined; use one handle per thread.
//
// Built by mxnet_tpu_torch/_build.py (c_predict_library) into the one C
// API library, beside the predict surface.
#include "py_embed.h"

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

thread_local std::string train_last_error;

using pyembed::GIL;

std::string py_err_str() { return pyembed::err_string(); }

bool ensure_python_rt() {
  return pyembed::ensure_interpreter(&train_last_error);
}

PyObject* bridge() {
  PyObject* mod = PyImport_ImportModule("mxnet_tpu_torch._c_api_bridge");
  if (mod == nullptr) train_last_error = py_err_str();
  return mod;
}

// Every handle wraps the bridge object plus per-handle caches for
// C-lifetime string/shape/byte returns.
struct Handle {
  PyObject* obj = nullptr;
  std::vector<std::string> str_store;
  std::vector<const char*> str_ptrs;
  std::vector<uint32_t> shape_store;
  std::string byte_store;
  // infer_shape result caches: CSR (indptr, data) per group.
  std::vector<uint32_t> infer_indptr[3];
  std::vector<uint32_t> infer_data[3];
};

Handle* wrap(PyObject* obj) {
  Handle* h = new Handle();
  h->obj = obj;
  return h;
}

PyObject* obj_of(void* h) { return static_cast<Handle*>(h)->obj; }

PyObject* str_list(uint32_t n, const char** items) {
  PyObject* list = PyList_New(n);
  if (list == nullptr) return nullptr;
  for (uint32_t i = 0; i < n; ++i)
    PyList_SET_ITEM(list, i, PyUnicode_FromString(items[i]));
  return list;
}

PyObject* shape_tuple(uint32_t ndim, const uint32_t* dims) {
  PyObject* tup = PyTuple_New(ndim);
  if (tup == nullptr) return nullptr;
  for (uint32_t i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(tup, i, PyLong_FromUnsignedLong(dims[i]));
  return tup;
}

// CSR-style shape pack (indptr[i]..indptr[i+1] owns input i's dims).
PyObject* shapes_csr(uint32_t num, const uint32_t* indptr,
                     const uint32_t* data) {
  PyObject* list = PyList_New(num);
  if (list == nullptr) return nullptr;
  for (uint32_t i = 0; i < num; ++i) {
    PyObject* tup = shape_tuple(indptr[i + 1] - indptr[i],
                                data + indptr[i]);
    if (tup == nullptr) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, i, tup);
  }
  return list;
}

// Call bridge.<fn>(...) returning a new reference (nullptr on error).
PyObject* call(const char* fn, const char* fmt, ...) {
  PyObject* mod = bridge();
  if (mod == nullptr) return nullptr;
  PyObject* meth = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (meth == nullptr) {
    train_last_error = py_err_str();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject* out = nullptr;
  if (args != nullptr) {
    out = PyObject_CallObject(meth, args);
    Py_DECREF(args);
  }
  Py_DECREF(meth);
  if (out == nullptr) train_last_error = py_err_str();
  return out;
}

int store_strings(PyObject* list, Handle* h, uint32_t* out_n,
                  const char*** out) {
  h->str_store.clear();
  h->str_ptrs.clear();
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(list); ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GET_ITEM(list, i));
    if (c == nullptr) {
      train_last_error = py_err_str();
      return -1;
    }
    h->str_store.emplace_back(c);
  }
  for (const std::string& s : h->str_store) h->str_ptrs.push_back(s.c_str());
  *out_n = static_cast<uint32_t>(h->str_ptrs.size());
  if (out != nullptr)
    *out = h->str_ptrs.empty() ? nullptr : h->str_ptrs.data();
  return 0;
}

}  // namespace

extern "C" {

const char* MXTTrainGetLastError() { return train_last_error.c_str(); }

// -- NDArray ---------------------------------------------------------------

// Zero-filled float32 NDArray.  dev_type: 1 = cpu, 2 = accelerator.
int MXTNDArrayCreate(const uint32_t* shape, uint32_t ndim, int dev_type,
                     int dev_id, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* tup = shape_tuple(ndim, shape);
  if (tup == nullptr) return -1;
  PyObject* arr = call("nd_create", "(Oii)", tup, dev_type, dev_id);
  Py_DECREF(tup);
  if (arr == nullptr) return -1;
  *out = wrap(arr);
  return 0;
}

// Create + fill from a flat little-endian float32 buffer.
int MXTNDArrayCreateFromBytes(const uint32_t* shape, uint32_t ndim,
                              const float* data, int dev_type, int dev_id,
                              void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  size_t n = 1;
  for (uint32_t i = 0; i < ndim; ++i) n *= shape[i];
  PyObject* tup = shape_tuple(ndim, shape);
  if (tup == nullptr) return -1;
  PyObject* arr = call("nd_from_bytes", "(Oy#ii)", tup,
                       reinterpret_cast<const char*>(data),
                       static_cast<Py_ssize_t>(n * sizeof(float)),
                       dev_type, dev_id);
  Py_DECREF(tup);
  if (arr == nullptr) return -1;
  *out = wrap(arr);
  return 0;
}

// Refill an existing NDArray in place from host memory (reference
// MXNDArraySyncCopyFromCPU).
int MXTNDArraySyncCopyFromCPU(void* handle, const float* data,
                              size_t size) {
  GIL gil;
  PyObject* r = call("nd_copy_from", "(Oy#)", obj_of(handle),
                     reinterpret_cast<const char*>(data),
                     static_cast<Py_ssize_t>(size * sizeof(float)));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Fetch to host memory as float32 (reference MXNDArraySyncCopyToCPU).
int MXTNDArraySyncCopyToCPU(void* handle, float* data, size_t size) {
  GIL gil;
  PyObject* bytes = call("nd_to_bytes", "(O)", obj_of(handle));
  if (bytes == nullptr) return -1;
  char* buf = nullptr;
  Py_ssize_t blen = 0;
  if (PyBytes_AsStringAndSize(bytes, &buf, &blen) != 0 ||
      static_cast<size_t>(blen) != size * sizeof(float)) {
    train_last_error = "MXTNDArraySyncCopyToCPU: size mismatch";
    Py_DECREF(bytes);
    return -1;
  }
  std::memcpy(data, buf, blen);
  Py_DECREF(bytes);
  return 0;
}

int MXTNDArrayGetShape(void* handle, uint32_t* out_dim,
                       const uint32_t** out_data) {
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  PyObject* tup = call("nd_shape", "(O)", h->obj);
  if (tup == nullptr) return -1;
  h->shape_store.clear();
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(tup); ++i)
    h->shape_store.push_back(static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GET_ITEM(tup, i))));
  Py_DECREF(tup);
  *out_dim = static_cast<uint32_t>(h->shape_store.size());
  *out_data = h->shape_store.empty() ? nullptr : h->shape_store.data();
  return 0;
}

void MXTNDArrayFree(void* handle) {
  if (handle == nullptr) return;
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  Py_XDECREF(h->obj);
  delete h;
}

// Save named NDArrays to the .params container format (reference
// MXNDArraySave).  keys may be null for list-style files.
int MXTNDArraySave(const char* fname, uint32_t num, void** handles,
                   const char** keys) {
  GIL gil;
  PyObject* names = keys != nullptr ? str_list(num, keys)
                                    : PyList_New(0);
  PyObject* arrays = PyList_New(num);
  if (names != nullptr && arrays != nullptr) {
    for (uint32_t i = 0; i < num; ++i) {
      PyObject* o = obj_of(handles[i]);
      Py_INCREF(o);
      PyList_SET_ITEM(arrays, i, o);
    }
  }
  PyObject* r = nullptr;
  if (names != nullptr && arrays != nullptr)
    r = call("nd_save", "(sOO)", fname, names, arrays);
  Py_XDECREF(names);
  Py_XDECREF(arrays);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Load a .params container.  The returned list handle owns the
// (keys, arrays) pair; fetch entries with MXTNDArrayLoadGet and free
// it with MXTNDArrayFree.  All key pointers stay valid until the list
// handle is freed (they are materialized up front into the handle's
// string cache).
int MXTNDArrayLoad(const char* fname, void** out_list, uint32_t* out_n) {
  *out_list = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* pair = call("nd_load", "(s)", fname);
  if (pair == nullptr) return -1;
  Handle* h = wrap(pair);
  uint32_t n = 0;
  if (store_strings(PyTuple_GET_ITEM(pair, 0), h, &n, nullptr) != 0) {
    MXTNDArrayFree(h);
    return -1;
  }
  *out_n = n;
  *out_list = h;
  return 0;
}

int MXTNDArrayLoadGet(void* list, uint32_t index, const char** out_key,
                      void** out_nd) {
  *out_nd = nullptr;
  GIL gil;
  Handle* h = static_cast<Handle*>(list);
  PyObject* arrays = PyTuple_GET_ITEM(h->obj, 1);
  if (index >= h->str_ptrs.size()) {
    train_last_error = "MXTNDArrayLoadGet: index out of range";
    return -1;
  }
  *out_key = h->str_ptrs[index];
  PyObject* arr = PyList_GET_ITEM(arrays, index);
  Py_INCREF(arr);
  *out_nd = wrap(arr);
  return 0;
}

// Row-range COPY of [begin, end) (functional arrays underneath: unlike
// the reference's MXNDArraySlice view, writes to the result do NOT
// propagate to the parent — refill the parent with SyncCopyFromCPU).
int MXTNDArraySlice(void* handle, uint32_t begin, uint32_t end,
                    void** out) {
  *out = nullptr;
  GIL gil;
  PyObject* o = call("nd_slice", "(OII)", obj_of(handle), begin, end);
  if (o == nullptr) return -1;
  *out = wrap(o);
  return 0;
}

int MXTNDArrayReshape(void* handle, uint32_t ndim, const uint32_t* dims,
                      void** out) {
  *out = nullptr;
  GIL gil;
  PyObject* tup = shape_tuple(ndim, dims);
  if (tup == nullptr) return -1;
  PyObject* o = call("nd_reshape", "(OO)", obj_of(handle), tup);
  Py_DECREF(tup);
  if (o == nullptr) return -1;
  *out = wrap(o);
  return 0;
}

// -- Symbol ----------------------------------------------------------------

int MXTSymbolCreateVariable(const char* name, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* s = call("sym_variable", "(s)", name);
  if (s == nullptr) return -1;
  *out = wrap(s);
  return 0;
}

// Atomic symbol creation + composition in one call: op attrs as
// key/value strings, symbol inputs as (arg_keys[i], args[i]) pairs.
// (The reference splits this into CreateAtomicSymbol + Compose.)
int MXTSymbolCreate(const char* op, const char* name, uint32_t num_attr,
                    const char** attr_keys, const char** attr_vals,
                    uint32_t num_args, const char** arg_keys, void** args,
                    void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* keys = str_list(num_attr, attr_keys);
  PyObject* vals = str_list(num_attr, attr_vals);
  PyObject* anames = str_list(num_args, arg_keys);
  PyObject* asyms = PyList_New(num_args);
  if (keys && vals && anames && asyms) {
    for (uint32_t i = 0; i < num_args; ++i) {
      PyObject* o = obj_of(args[i]);
      Py_INCREF(o);
      PyList_SET_ITEM(asyms, i, o);
    }
  }
  PyObject* s = nullptr;
  if (keys && vals && anames && asyms)
    s = call("sym_create", "(ssOOOO)", op, name ? name : "", keys, vals,
             anames, asyms);
  Py_XDECREF(keys);
  Py_XDECREF(vals);
  Py_XDECREF(anames);
  Py_XDECREF(asyms);
  if (s == nullptr) return -1;
  *out = wrap(s);
  return 0;
}

int MXTSymbolCreateFromJSON(const char* json, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* s = call("sym_from_json", "(s)", json);
  if (s == nullptr) return -1;
  *out = wrap(s);
  return 0;
}

int MXTSymbolSaveToJSON(void* handle, const char** out_json) {
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  PyObject* s = call("sym_to_json", "(O)", h->obj);
  if (s == nullptr) return -1;
  const char* c = PyUnicode_AsUTF8(s);
  if (c == nullptr) {
    train_last_error = py_err_str();
    Py_DECREF(s);
    return -1;
  }
  h->byte_store = c;
  Py_DECREF(s);
  *out_json = h->byte_store.c_str();
  return 0;
}

static int sym_name_list(void* handle, const char* fn, uint32_t* out_n,
                         const char*** out) {
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  PyObject* list = call(fn, "(O)", h->obj);
  if (list == nullptr) return -1;
  int rc = store_strings(list, h, out_n, out);
  Py_DECREF(list);
  return rc;
}

int MXTSymbolListArguments(void* handle, uint32_t* out_n,
                           const char*** out) {
  return sym_name_list(handle, "sym_list_arguments", out_n, out);
}

int MXTSymbolListOutputs(void* handle, uint32_t* out_n,
                         const char*** out) {
  return sym_name_list(handle, "sym_list_outputs", out_n, out);
}

int MXTSymbolListAuxiliaryStates(void* handle, uint32_t* out_n,
                                 const char*** out) {
  return sym_name_list(handle, "sym_list_aux", out_n, out);
}

static int handle_by_index(const char* fn, void* handle, uint32_t idx,
                           void** out);
static int handle_by_name(const char* fn, void* handle, const char* name,
                          void** out);

static int handle_plain(const char* fn, void* handle, void** out) {
  GIL gil;
  PyObject* o = call(fn, "(O)", obj_of(handle));
  if (o == nullptr) return -1;
  *out = wrap(o);
  return 0;
}

// Graph surgery handles (reference MXSymbolGetInternals/GetOutput).
int MXTSymbolGetInternals(void* handle, void** out) {
  *out = nullptr;
  return handle_plain("sym_get_internals", handle, out);
}

int MXTSymbolGetOutput(void* handle, uint32_t index, void** out) {
  *out = nullptr;
  return handle_by_index("sym_get_output", handle, index, out);
}

int MXTSymbolGetInternalByName(void* handle, const char* name,
                               void** out) {
  *out = nullptr;
  return handle_by_name("sym_get_internal_by_name", handle, name, out);
}

// Attribute get/set (reference MXSymbolGetAttr/SetAttr).  out_present
// carries the set/unset distinction (an attribute explicitly set to ""
// reports present=1); the string pointer is handle-cached.
int MXTSymbolGetAttr(void* handle, const char* key, const char** out,
                     int* out_present) {
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  PyObject* pair = call("sym_attr_get", "(Os)", h->obj, key);
  if (pair == nullptr) return -1;
  long present = PyLong_AsLong(PyTuple_GET_ITEM(pair, 0));
  const char* c = PyUnicode_AsUTF8(PyTuple_GET_ITEM(pair, 1));
  if (c == nullptr) {
    train_last_error = py_err_str();
    Py_DECREF(pair);
    return -1;
  }
  h->byte_store = c;
  Py_DECREF(pair);
  *out = h->byte_store.c_str();
  if (out_present != nullptr) *out_present = static_cast<int>(present);
  return 0;
}

int MXTSymbolSetAttr(void* handle, const char* key, const char* value) {
  GIL gil;
  PyObject* r = call("sym_attr_set", "(Oss)", obj_of(handle), key,
                     value);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Bidirectional shape inference (reference MXSymbolInferShape): provide
// shapes for some args CSR-style; receive complete arg/out/aux shape
// lists, each returned CSR-style with handle-cached lifetime.
int MXTSymbolInferShape(void* handle, uint32_t num_provided,
                        const char** keys, const uint32_t* indptr,
                        const uint32_t* shape_data,
                        uint32_t* arg_count, const uint32_t** arg_indptr,
                        const uint32_t** arg_data,
                        uint32_t* out_count, const uint32_t** out_indptr,
                        const uint32_t** out_data,
                        uint32_t* aux_count, const uint32_t** aux_indptr,
                        const uint32_t** aux_data) {
  GIL gil;
  Handle* h = static_cast<Handle*>(handle);
  PyObject* names = str_list(num_provided, keys);
  PyObject* shapes = shapes_csr(num_provided, indptr, shape_data);
  PyObject* triple = nullptr;
  if (names && shapes)
    triple = call("sym_infer_shape", "(OOO)", h->obj, names, shapes);
  Py_XDECREF(names);
  Py_XDECREF(shapes);
  if (triple == nullptr) return -1;
  uint32_t* counts[3] = {arg_count, out_count, aux_count};
  const uint32_t** iptrs[3] = {arg_indptr, out_indptr, aux_indptr};
  const uint32_t** datas[3] = {arg_data, out_data, aux_data};
  for (int g = 0; g < 3; ++g) {
    PyObject* group = PyTuple_GET_ITEM(triple, g);
    h->infer_indptr[g].assign(1, 0);
    h->infer_data[g].clear();
    Py_ssize_t n = PyList_GET_SIZE(group);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* tup = PyList_GET_ITEM(group, i);
      if (PyTuple_Check(tup)) {
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(tup); ++j)
          h->infer_data[g].push_back(static_cast<uint32_t>(
              PyLong_AsUnsignedLong(PyTuple_GET_ITEM(tup, j))));
      }
      h->infer_indptr[g].push_back(
          static_cast<uint32_t>(h->infer_data[g].size()));
    }
    *counts[g] = static_cast<uint32_t>(n);
    *iptrs[g] = h->infer_indptr[g].data();
    *datas[g] = h->infer_data[g].empty() ? nullptr
                                         : h->infer_data[g].data();
  }
  Py_DECREF(triple);
  if (PyErr_Occurred()) {
    train_last_error = py_err_str();
    return -1;
  }
  return 0;
}

void MXTSymbolFree(void* handle) { MXTNDArrayFree(handle); }

// -- Executor --------------------------------------------------------------

// simple_bind: shapes for the named args arrive CSR-style.
int MXTExecutorSimpleBind(void* sym, int dev_type, int dev_id,
                          const char* grad_req, uint32_t num_provided,
                          const char** keys, const uint32_t* indptr,
                          const uint32_t* shape_data, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* names = str_list(num_provided, keys);
  PyObject* shapes = shapes_csr(num_provided, indptr, shape_data);
  PyObject* ex = nullptr;
  if (names && shapes)
    ex = call("simple_bind", "(OiisOO)", obj_of(sym), dev_type, dev_id,
              grad_req, names, shapes);
  Py_XDECREF(names);
  Py_XDECREF(shapes);
  if (ex == nullptr) return -1;
  *out = wrap(ex);
  return 0;
}

int MXTExecutorForward(void* handle, int is_train) {
  GIL gil;
  PyObject* r = call("ex_forward", "(Oi)", obj_of(handle), is_train);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int MXTExecutorBackward(void* handle) {
  GIL gil;
  PyObject* r = call("ex_backward", "(O)", obj_of(handle));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int MXTExecutorNumOutputs(void* handle, uint32_t* out_n) {
  GIL gil;
  PyObject* r = call("ex_num_outputs", "(O)", obj_of(handle));
  if (r == nullptr) return -1;
  *out_n = static_cast<uint32_t>(PyLong_AsUnsignedLong(r));
  Py_DECREF(r);
  return 0;
}

static int handle_by_index(const char* fn, void* handle, uint32_t idx,
                           void** out) {
  GIL gil;
  PyObject* o = call(fn, "(OI)", obj_of(handle), idx);
  if (o == nullptr) return -1;
  *out = wrap(o);
  return 0;
}

static int handle_by_name(const char* fn, void* handle, const char* name,
                          void** out) {
  GIL gil;
  PyObject* o = call(fn, "(Os)", obj_of(handle), name);
  if (o == nullptr) return -1;
  *out = wrap(o);
  return 0;
}

// Output i as a new NDArray handle (shares the device buffer).
int MXTExecutorOutput(void* handle, uint32_t index, void** out) {
  *out = nullptr;
  return handle_by_index("ex_output", handle, index, out);
}

// Bound argument / gradient arrays by name (the reference returns
// positional arrays from Bind; by-name is the simpler contract and maps
// 1:1 onto arg_dict/grad_dict).
int MXTExecutorArgArray(void* handle, const char* name, void** out) {
  *out = nullptr;
  return handle_by_name("ex_arg", handle, name, out);
}

int MXTExecutorGradArray(void* handle, const char* name, void** out) {
  *out = nullptr;
  return handle_by_name("ex_grad", handle, name, out);
}

void MXTExecutorFree(void* handle) { MXTNDArrayFree(handle); }

// -- Optimizer -------------------------------------------------------------

// An updater = optimizer instance + per-index state (reference
// kvstore updater semantics: same index -> same state slot).
int MXTUpdaterCreate(const char* opt_name, uint32_t num_attr,
                     const char** attr_keys, const char** attr_vals,
                     void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* keys = str_list(num_attr, attr_keys);
  PyObject* vals = str_list(num_attr, attr_vals);
  PyObject* u = nullptr;
  if (keys && vals)
    u = call("updater_create", "(sOO)", opt_name, keys, vals);
  Py_XDECREF(keys);
  Py_XDECREF(vals);
  if (u == nullptr) return -1;
  *out = wrap(u);
  return 0;
}

int MXTUpdaterStep(void* updater, int index, void* grad, void* weight) {
  GIL gil;
  PyObject* r = call("updater_step", "(OiOO)", obj_of(updater), index,
                     obj_of(grad), obj_of(weight));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

void MXTUpdaterFree(void* handle) { MXTNDArrayFree(handle); }

// -- KVStore ---------------------------------------------------------------

int MXTKVStoreCreate(const char* kind, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* kv = call("kv_create", "(s)", kind);
  if (kv == nullptr) return -1;
  *out = wrap(kv);
  return 0;
}

static int kv_op(const char* fn, void* kv, const char* key, void* nd) {
  GIL gil;
  PyObject* r = call(fn, "(OsO)", obj_of(kv), key, obj_of(nd));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int MXTKVStoreInit(void* kv, const char* key, void* nd) {
  return kv_op("kv_init", kv, key, nd);
}

int MXTKVStorePush(void* kv, const char* key, void* nd) {
  return kv_op("kv_push", kv, key, nd);
}

int MXTKVStorePull(void* kv, const char* key, void* nd) {
  return kv_op("kv_pull", kv, key, nd);
}

void MXTKVStoreFree(void* handle) { MXTNDArrayFree(handle); }

// -- Imperative invoke + autograd ------------------------------------------
//
// The reference's imperative heart (MXImperativeInvoke,
// src/c_api/c_api_ndarray.cc:423): any registered op,
// by name, on NDArray handles — plus autograd record/backward
// (c_api_ndarray.cc:545-621) so a C caller can differentiate outside a
// bound executor, and the CachedOp mini-JIT (c_api_ndarray.cc:464-485).

namespace {

PyObject* handle_list(uint32_t n, void** handles) {
  PyObject* list = PyList_New(n);
  if (list == nullptr) return nullptr;
  for (uint32_t i = 0; i < n; ++i) {
    PyObject* o = obj_of(handles[i]);
    Py_INCREF(o);
    PyList_SET_ITEM(list, i, o);
  }
  return list;
}

// Unpack a bridge list of NDArrays into caller-supplied handle slots.
int unpack_outputs(PyObject* list, uint32_t max_outputs,
                   uint32_t* num_outputs, void** outputs) {
  Py_ssize_t n = PyList_GET_SIZE(list);
  if (static_cast<uint32_t>(n) > max_outputs) {
    train_last_error = "output array too small: need " +
                       std::to_string(n) + " slots";
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* o = PyList_GET_ITEM(list, i);
    Py_INCREF(o);
    outputs[i] = wrap(o);
  }
  *num_outputs = static_cast<uint32_t>(n);
  return 0;
}

}  // namespace

// Global runtime controls (reference MXRandomSeed / MXNDArrayWaitAll).
int MXTRandomSeed(int seed) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* r = call("random_seed", "(i)", seed);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int MXTNDArrayWaitAll() {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* r = call("wait_all", "()");
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Op introspection — the reference's MXSymbolListAtomicSymbolCreators
// + MXSymbolGetAtomicSymbolInfo pair, which binding codegen walks to
// build a language's op namespace.  The caches below rebuild whenever
// the Python registry's generation stamp changes, so ops registered at
// runtime (CustomOp) appear instead of a stale first-call snapshot
// silently diverging from the live registry imperative_invoke
// consults.  Returned pointers keep the original static-lifetime
// contract: superseded cache entries are retired, not freed, so a
// caller holding a pre-refresh list never dereferences freed memory
// (it just sees a stale snapshot).

// Live registry generation stamp (bumped on every registration,
// including re-registration of an existing name); -1 on bridge
// failure.  Caller holds the GIL.
static long op_registry_generation_now() {
  PyObject* r = call("op_registry_generation", "()");
  if (r == nullptr) return -1;
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  return n;
}

// Superseded cache entries are retired, never freed: the pre-refresh
// contract gave returned pointers registry (static) lifetime, and a
// caller iterating a name list while another thread registers an op
// must not land on freed memory.  Growth is bounded by the number of
// runtime registrations observed by the introspection calls.
static void retire_handle(void* h) {
  static std::vector<void*>* retired = new std::vector<void*>();
  if (h != nullptr) retired->push_back(h);
}

int MXTListOpNames(uint32_t* out_n, const char*** out_names) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  static Handle* cache = nullptr;
  static long cache_gen = -1;
  long gen = op_registry_generation_now();
  if (gen < 0) return -1;
  if (cache == nullptr || gen != cache_gen) {
    PyObject* names = call("list_op_names", "()");
    if (names == nullptr) return -1;
    Handle* h = wrap(names);
    uint32_t n = 0;
    if (store_strings(names, h, &n, nullptr) != 0) {
      MXTNDArrayFree(h);
      return -1;
    }
    retire_handle(cache);   // old pointers stay valid (never freed)
    cache = h;
    cache_gen = gen;
  }
  *out_n = static_cast<uint32_t>(cache->str_ptrs.size());
  *out_names = cache->str_ptrs.data();
  return 0;
}

int MXTOpGetInfo(const char* name, const char** canonical_name,
                 const char** description, uint32_t* num_inputs,
                 const char*** input_names) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  static std::map<std::string, Handle*>* cache = nullptr;
  static long cache_gen = -1;
  if (cache == nullptr) cache = new std::map<std::string, Handle*>();
  long gen = op_registry_generation_now();
  if (gen < 0) return -1;
  if (gen != cache_gen) {
    // registry changed: a cached name may now resolve differently
    // (e.g. a CustomOp re-registered with new inputs) — retire it
    // all (old pointers stay valid, see retire_handle)
    for (auto& kv : *cache) retire_handle(kv.second);
    cache->clear();
    cache_gen = gen;
  }
  Handle* h;
  auto it = cache->find(name);
  if (it != cache->end()) {
    h = it->second;
  } else {
    // bridge returns [canonical, description, in0, in1, ...]
    PyObject* info = call("op_info", "(s)", name);
    if (info == nullptr) return -1;
    h = wrap(info);
    uint32_t n = 0;
    int src = store_strings(info, h, &n, nullptr);
    if (src != 0 || n < 2) {
      // store_strings failure already carries the real Python error;
      // only a successful-but-short reply needs its own message
      if (src == 0) train_last_error = "op_info: short reply from bridge";
      MXTNDArrayFree(h);
      return -1;
    }
    // call() may release the GIL: the registry can mutate (and
    // another caller advance cache_gen) while op_info ran, so only
    // insert if the generation still matches the one observed at
    // ENTRY (not cache_gen, which a concurrent refresher may already
    // have advanced past our pre-mutation info) — a stale insert
    // under the new generation would be served until the NEXT bump.
    // The answer itself is still returned (retired, never freed).
    if (op_registry_generation_now() == gen) {
      cache->emplace(name, h);
    } else {
      retire_handle(h);
    }
  }
  *canonical_name = h->str_ptrs[0];
  *description = h->str_ptrs[1];
  *num_inputs = static_cast<uint32_t>(h->str_ptrs.size() - 2);
  *input_names = *num_inputs ? h->str_ptrs.data() + 2 : nullptr;
  return 0;
}

// Run a registered operator imperatively.  `outputs` is a caller array
// with `max_outputs` slots; on success `*num_outputs` handles are
// written (each freed with MXTNDArrayFree).
int MXTImperativeInvoke(const char* op_name, uint32_t num_inputs,
                        void** inputs, uint32_t num_params,
                        const char** param_keys, const char** param_vals,
                        uint32_t* num_outputs, void** outputs,
                        uint32_t max_outputs) {
  *num_outputs = 0;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* ins = handle_list(num_inputs, inputs);
  PyObject* keys = str_list(num_params, param_keys);
  PyObject* vals = str_list(num_params, param_vals);
  PyObject* outs = nullptr;
  if (ins && keys && vals)
    outs = call("imperative_invoke", "(sOOO)", op_name, ins, keys, vals);
  Py_XDECREF(ins);
  Py_XDECREF(keys);
  Py_XDECREF(vals);
  if (outs == nullptr) return -1;
  int rc = unpack_outputs(outs, max_outputs, num_outputs, outputs);
  Py_DECREF(outs);
  return rc;
}

// Toggle tape recording / train mode; previous state lands in *prev
// (reference MXAutogradSetIsRecording / MXAutogradSetIsTraining).
int MXTAutogradSetIsRecording(int flag, int* prev) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* r = call("autograd_set_recording", "(i)", flag);
  if (r == nullptr) return -1;
  if (prev != nullptr) *prev = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTAutogradSetIsTraining(int flag, int* prev) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* r = call("autograd_set_training", "(i)", flag);
  if (r == nullptr) return -1;
  if (prev != nullptr) *prev = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

// Attach gradient buffers to arrays (reference MXAutogradMarkVariables).
// grad_reqs may be null (every variable gets 'write').
int MXTAutogradMarkVariables(uint32_t num, void** vars,
                             const char** grad_reqs) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* vs = handle_list(num, vars);
  PyObject* reqs;
  if (grad_reqs != nullptr) {
    reqs = str_list(num, grad_reqs);
  } else {
    reqs = PyList_New(num);
    if (reqs != nullptr)
      for (uint32_t i = 0; i < num; ++i)
        PyList_SET_ITEM(reqs, i, PyUnicode_FromString("write"));
  }
  PyObject* r = nullptr;
  if (vs && reqs) r = call("autograd_mark_variables", "(OO)", vs, reqs);
  Py_XDECREF(vs);
  Py_XDECREF(reqs);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Backprop from heads through the recorded tape (reference
// MXAutogradBackwardEx); gradients land in the marked variables'
// buffers, readable via MXTNDArrayGetGrad.
int MXTAutogradBackward(uint32_t num_heads, void** heads,
                        int retain_graph) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* hs = handle_list(num_heads, heads);
  if (hs == nullptr) return -1;
  PyObject* r = call("autograd_backward", "(Oi)", hs, retain_graph);
  Py_DECREF(hs);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// The gradient buffer of a marked variable (reference MXNDArrayGetGrad).
int MXTNDArrayGetGrad(void* handle, void** out) {
  *out = nullptr;
  GIL gil;
  PyObject* g = call("nd_get_grad", "(O)", obj_of(handle));
  if (g == nullptr) return -1;
  *out = wrap(g);
  return 0;
}

// -- CachedOp --------------------------------------------------------------

// Compile a symbol for repeated imperative invocation (reference
// MXCreateCachedOp).  Invocation inputs arrive in list_arguments() +
// list_auxiliary_states() order; each distinct input signature jits
// once and replays thereafter.  Invoked under recording, the whole
// cached graph differentiates as one tape op.
int MXTCachedOpCreate(void* sym, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* op = call("cached_op_create", "(O)", obj_of(sym));
  if (op == nullptr) return -1;
  *out = wrap(op);
  return 0;
}

int MXTCachedOpInvoke(void* cached, uint32_t num_inputs, void** inputs,
                      uint32_t* num_outputs, void** outputs,
                      uint32_t max_outputs) {
  *num_outputs = 0;
  GIL gil;
  PyObject* ins = handle_list(num_inputs, inputs);
  if (ins == nullptr) return -1;
  PyObject* outs = call("cached_op_invoke", "(OO)", obj_of(cached), ins);
  Py_DECREF(ins);
  if (outs == nullptr) return -1;
  int rc = unpack_outputs(outs, max_outputs, num_outputs, outputs);
  Py_DECREF(outs);
  return rc;
}

void MXTCachedOpFree(void* handle) { MXTNDArrayFree(handle); }

// -- DataIter --------------------------------------------------------------
//
// The reference's iterator C surface (MXListDataIters /
// MXDataIterCreateIter / Next / GetData / GetLabel,
// src/c_api/c_api.cc) — what lets every language
// binding train from .rec/.csv files without touching Python.

// List the string-creatable iterators.  Pointers stay valid for the
// process lifetime (cached in a static handle).
int MXTListDataIters(uint32_t* out_n, const char*** out_names) {
  if (!ensure_python_rt()) return -1;
  GIL gil;
  static Handle* cache = nullptr;
  if (cache == nullptr) {
    PyObject* names = call("list_data_iters", "()");
    if (names == nullptr) return -1;
    Handle* h = wrap(names);
    uint32_t n = 0;
    if (store_strings(names, h, &n, nullptr) != 0) {
      MXTNDArrayFree(h);
      return -1;
    }
    cache = h;
  }
  *out_n = static_cast<uint32_t>(cache->str_ptrs.size());
  *out_names = cache->str_ptrs.data();
  return 0;
}

// Create an iterator by registered name with string params (reference
// MXDataIterCreateIter; params are the same key=value strings the
// Python constructors take).
int MXTDataIterCreate(const char* name, uint32_t num_param,
                      const char** keys, const char** vals, void** out) {
  *out = nullptr;
  if (!ensure_python_rt()) return -1;
  GIL gil;
  PyObject* k = str_list(num_param, keys);
  PyObject* v = str_list(num_param, vals);
  PyObject* it = nullptr;
  if (k && v) it = call("data_iter_create", "(sOO)", name, k, v);
  Py_XDECREF(k);
  Py_XDECREF(v);
  if (it == nullptr) return -1;
  *out = wrap(it);
  return 0;
}

int MXTDataIterBeforeFirst(void* handle) {
  GIL gil;
  PyObject* r = call("data_iter_before_first", "(O)", obj_of(handle));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Advance; *out_has_next = 0 at end of epoch (reference MXDataIterNext).
int MXTDataIterNext(void* handle, int* out_has_next) {
  *out_has_next = 0;
  GIL gil;
  PyObject* r = call("data_iter_next", "(O)", obj_of(handle));
  if (r == nullptr) return -1;
  *out_has_next = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

static int iter_get(const char* fn, void* handle, void** out) {
  *out = nullptr;
  GIL gil;
  PyObject* arr = call(fn, "(O)", obj_of(handle));
  if (arr == nullptr) return -1;
  *out = wrap(arr);
  return 0;
}

// Current batch's data / label as NDArray handles (freed by caller).
int MXTDataIterGetData(void* handle, void** out) {
  return iter_get("data_iter_get_data", handle, out);
}

int MXTDataIterGetLabel(void* handle, void** out) {
  return iter_get("data_iter_get_label", handle, out);
}

// Pad count of the current batch (tail-batch refill, reference
// MXDataIterGetPadNum).
int MXTDataIterGetPadNum(void* handle, int* out_pad) {
  *out_pad = 0;
  GIL gil;
  PyObject* r = call("data_iter_get_pad", "(O)", obj_of(handle));
  if (r == nullptr) return -1;
  *out_pad = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

void MXTDataIterFree(void* handle) { MXTNDArrayFree(handle); }

// Device-side copy dst[:] = src — feeds executor-bound arrays straight
// from iterator batches (reference _copyto / executor _load_general).
int MXTNDArrayCopyFromNDArray(void* dst, void* src) {
  GIL gil;
  PyObject* r = call("nd_copy_from_nd", "(OO)", obj_of(dst),
                     obj_of(src));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

}  // extern "C"
