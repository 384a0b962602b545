// Embedded-CPython glue of the port's C predict API: interpreter
// bring-up, GIL RAII, and python-exception -> string capture. A copy of
// src/py_embed.h (the JAX package's) that also puts the paths the library
// was built with (MXT_PY_PATHS: the repository and the building
// interpreter's site-packages, os.pathsep-separated) at the front of
// sys.path when it brings the interpreter up, so that a plain C program
// finds mxnet_tpu_torch and torch without a PYTHONPATH.
#ifndef MXNET_TPU_TORCH_CSRC_CAPI_PY_EMBED_H_
#define MXNET_TPU_TORCH_CSRC_CAPI_PY_EMBED_H_

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>

#include <string>

namespace pyembed {

#define PYEMBED_STR_(x) #x
#define PYEMBED_STR(x) PYEMBED_STR_(x)

// Python C-extension modules (numpy etc.) resolve Py* symbols from the
// process's GLOBAL dynamic namespace — they do not link libpython
// themselves.  When this library is loaded by a plugin host that uses
// RTLD_LOCAL (perl XS, ruby, lua...), the libpython our embedded
// interpreter came from is invisible to them and every extension
// import fails.  Re-open the already-loaded libpython with
// RTLD_GLOBAL (RTLD_NOLOAD: never load a second copy) to promote its
// symbols.  No-op in ordinary C programs and inside real Python.
inline void promote_libpython() {
  const char* names[] = {
      "libpython" PYEMBED_STR(PY_MAJOR_VERSION) "."
      PYEMBED_STR(PY_MINOR_VERSION) ".so.1.0",
      "libpython" PYEMBED_STR(PY_MAJOR_VERSION) "."
      PYEMBED_STR(PY_MINOR_VERSION) ".so",
  };
  for (const char* n : names) {
    if (dlopen(n, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD) != nullptr)
      return;
  }
}

inline std::string err_string();

// Put MXT_PY_PATHS at the front of sys.path, in order. Called with the
// GIL held, right after the interpreter came up.
inline bool prepend_paths(std::string* err) {
#ifdef MXT_PY_PATHS
  const std::string paths = MXT_PY_PATHS;
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  if (sys_path == nullptr || !PyList_Check(sys_path)) {
    if (err != nullptr) *err = "embedded Python has no sys.path list";
    return false;
  }
  Py_ssize_t at = 0;
  size_t start = 0;
  while (start <= paths.size()) {
    size_t end = paths.find(':', start);
    if (end == std::string::npos) end = paths.size();
    if (end > start) {
      PyObject* p = PyUnicode_FromStringAndSize(paths.data() + start,
                                                end - start);
      if (p == nullptr || PyList_Insert(sys_path, at++, p) != 0) {
        Py_XDECREF(p);
        if (err != nullptr) *err = err_string();
        return false;
      }
      Py_DECREF(p);
    }
    start = end + 1;
  }
#else
  (void)err;
#endif
  return true;
}

inline std::string err_string() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

// Lazily bring up the interpreter when the library is used from a plain
// C program; inside a Python process Py_IsInitialized() is already true
// and this is a no-op.  (First call from multiple raw threads at once
// would race Py_InitializeEx; callers start single-threaded, matching
// the reference's implicit init contract.)
inline bool ensure_interpreter(std::string* err) {
  if (!Py_IsInitialized()) {
    promote_libpython();
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      if (err != nullptr) *err = "failed to initialize embedded Python";
      return false;
    }
    if (!prepend_paths(err)) return false;
    // Drop the GIL the init acquired so every API call can use the
    // uniform PyGILState_Ensure/Release pairing regardless of thread.
    PyEval_SaveThread();
  }
  return true;
}

struct GIL {
  GIL() : state(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(state); }
  PyGILState_STATE state;
};

}  // namespace pyembed

#endif  // MXNET_TPU_TORCH_CSRC_CAPI_PY_EMBED_H_
