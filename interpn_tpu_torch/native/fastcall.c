/* _interpn_fastcall: minimal-overhead call layer for the native kernels.
 *
 * The ctypes binding costs ~10 us per call in Python-side argument
 * marshalling — visible at the reference's headline "1 observation point"
 * regime. This CPython extension (C API + buffer protocol only; no numpy
 * headers, no pybind11) exposes a PreparedCall object that freezes the
 * grid-constant arguments at construction; a warm call does only:
 *   - PyBuffer acquisition of each observation array and the output
 *   - the kernel function call
 * for ~1-2 us total.
 *
 * The kernel function pointers come from the ctypes-loaded shared library
 * (passed in as integer addresses by interpn_tpu.native); this module is
 * pure call plumbing and performs no numerics itself.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

#define MAXDIMS 8

/* Float buffers only: "f" (f32) / "d" (f64). An itemsize match alone would
 * let int64/int32 buffers through and bit-reinterpret them as floats; the
 * ctypes slow path converts dtypes correctly, so mismatches fall back. */
static int format_is_float(const Py_buffer *buf, int itemsize) {
  if (buf->itemsize != itemsize) return 0;
  if (buf->format == NULL) return 0; /* unsigned bytes per buffer protocol */
  const char *f = buf->format;
  if (f[0] == '@' || f[0] == '=') f++; /* native byte-order prefixes */
  if (f[0] == '\0' || f[1] != '\0') return 0;
  return itemsize == 8 ? f[0] == 'd' : f[0] == 'f';
}

/* Kernel signatures (matching interpn_native.cpp extern "C"). */
typedef int (*regular_fn)(const int64_t *, int, const void *, const void *,
                          const void *, const void *const *, void *, int64_t);
typedef int (*cubic_regular_fn)(const int64_t *, int, const void *,
                                const void *, const void *, int,
                                const void *const *, void *, int64_t);
typedef int (*rect_fn)(const void *const *, const int64_t *, int, const void *,
                       const void *const *, void *, int64_t);
typedef int (*cubic_rect_fn)(const void *const *, const int64_t *, int,
                             const void *, int, const void *const *, void *,
                             int64_t);

typedef enum {
  KIND_REGULAR = 0,
  KIND_CUBIC_REGULAR = 1,
  KIND_RECT = 2,
  KIND_CUBIC_RECT = 3,
} CallKind;

typedef struct {
  PyObject_HEAD
  void *fn;
  int kind;
  int ndims;
  int linearize;
  int itemsize; /* 8 for f64, 4 for f32 */
  int64_t dims[MAXDIMS];
  const void *starts; /* regular kinds */
  const void *steps;
  const void *grid_ptrs[MAXDIMS]; /* rect kinds */
  const void *vals;
  PyObject *keep; /* tuple of arrays keeping the pointers alive */
} PreparedCall;

static void PreparedCall_dealloc(PreparedCall *self) {
  Py_XDECREF(self->keep);
  Py_TYPE(self)->tp_free((PyObject *)self);
}

/* __call__(obs_tuple, out) -> bool
 * obs entries and out must be C-contiguous 1-D buffers of the right
 * itemsize; anything else returns False so the caller can fall back. */
static PyObject *PreparedCall_call(PreparedCall *self, PyObject *args,
                                   PyObject *kwargs) {
  PyObject *obs;
  PyObject *out;
  if (kwargs != NULL && PyDict_GET_SIZE(kwargs) != 0) {
    PyErr_SetString(PyExc_TypeError, "no keyword arguments");
    return NULL;
  }
  if (!PyArg_ParseTuple(args, "OO", &obs, &out)) return NULL;

  PyObject *seq = PySequence_Fast(obs, "obs must be a sequence");
  if (seq == NULL) return NULL;
  Py_ssize_t nobs = PySequence_Fast_GET_SIZE(seq);
  if (nobs != self->ndims) {
    Py_DECREF(seq);
    Py_RETURN_FALSE;
  }

  Py_buffer bufs[MAXDIMS];
  const void *obs_ptrs[MAXDIMS];
  int acquired = 0;
  Py_buffer out_buf;
  int ok = 1;
  int64_t n = -1;

  for (Py_ssize_t i = 0; i < nobs; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &bufs[i], PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
        0) {
      PyErr_Clear();
      ok = 0;
      break;
    }
    acquired++;
    if (!format_is_float(&bufs[i], self->itemsize)) {
      ok = 0;
      break;
    }
    int64_t len = (int64_t)(bufs[i].len / bufs[i].itemsize);
    if (n < 0) n = len;
    if (len != n) {
      ok = 0;
      break;
    }
    obs_ptrs[i] = bufs[i].buf;
  }

  int have_out = 0;
  if (ok) {
    if (PyObject_GetBuffer(out, &out_buf,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) !=
        0) {
      PyErr_Clear();
      ok = 0;
    } else {
      have_out = 1;
      if (!format_is_float(&out_buf, self->itemsize) ||
          (int64_t)(out_buf.len / out_buf.itemsize) != n) {
        ok = 0;
      }
    }
  }

  int rc = 1;
  if (ok) {
    switch ((CallKind)self->kind) {
      case KIND_REGULAR:
        rc = ((regular_fn)self->fn)(self->dims, self->ndims, self->starts,
                                    self->steps, self->vals, obs_ptrs,
                                    out_buf.buf, n);
        break;
      case KIND_CUBIC_REGULAR:
        rc = ((cubic_regular_fn)self->fn)(self->dims, self->ndims, self->starts,
                                          self->steps, self->vals,
                                          self->linearize, obs_ptrs,
                                          out_buf.buf, n);
        break;
      case KIND_RECT:
        rc = ((rect_fn)self->fn)(self->grid_ptrs, self->dims, self->ndims,
                                 self->vals, obs_ptrs, out_buf.buf, n);
        break;
      case KIND_CUBIC_RECT:
        rc = ((cubic_rect_fn)self->fn)(self->grid_ptrs, self->dims, self->ndims,
                                       self->vals, self->linearize, obs_ptrs,
                                       out_buf.buf, n);
        break;
    }
  }

  for (int i = 0; i < acquired; i++) PyBuffer_Release(&bufs[i]);
  if (have_out) PyBuffer_Release(&out_buf);
  Py_DECREF(seq);

  if (ok && rc == 0) Py_RETURN_TRUE;
  if (ok && rc == 2) {
    /* Reference parity (src/multilinear/regular.rs:418 via python.rs:78):
     * NaN/inf/out-of-int64-range coordinates raise, never fall back. */
    PyErr_SetString(PyExc_AssertionError, "Unrepresentable coordinate value");
    return NULL;
  }
  Py_RETURN_FALSE;
}

static PyTypeObject PreparedCallType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_interpn_fastcall.PreparedCall",
    .tp_basicsize = sizeof(PreparedCall),
    .tp_dealloc = (destructor)PreparedCall_dealloc,
    .tp_call = (ternaryfunc)PreparedCall_call,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Frozen-argument native kernel call",
};

/* prepare(fn_addr, kind, ndims, linearize, itemsize, dims_tuple,
 *         starts_addr, steps_addr, grid_addrs_tuple, vals_addr, keep)
 * Addresses are integers (array.ctypes.data); `keep` is any object whose
 * lifetime guards every address passed here. */
static PyObject *prepare(PyObject *self, PyObject *args) {
  unsigned long long fn_addr, starts_addr, steps_addr, vals_addr;
  int kind, ndims, linearize, itemsize;
  PyObject *dims_tuple, *grid_addrs, *keep;
  if (!PyArg_ParseTuple(args, "KiiiiOKKOKO", &fn_addr, &kind, &ndims,
                        &linearize, &itemsize, &dims_tuple, &starts_addr,
                        &steps_addr, &grid_addrs, &vals_addr, &keep))
    return NULL;
  if (ndims < 1 || ndims > MAXDIMS) {
    PyErr_SetString(PyExc_ValueError, "ndims out of range");
    return NULL;
  }
  PreparedCall *pc = PyObject_New(PreparedCall, &PreparedCallType);
  if (pc == NULL) return NULL;
  /* PyObject_New does not zero memory; dealloc on the early-return error
   * paths below reads pc->keep, so it must be valid before any DECREF. */
  pc->keep = NULL;
  pc->fn = (void *)(uintptr_t)fn_addr;
  pc->kind = kind;
  pc->ndims = ndims;
  pc->linearize = linearize;
  pc->itemsize = itemsize;
  pc->starts = (const void *)(uintptr_t)starts_addr;
  pc->steps = (const void *)(uintptr_t)steps_addr;
  pc->vals = (const void *)(uintptr_t)vals_addr;
  for (int i = 0; i < ndims; i++) {
    PyObject *d = PySequence_GetItem(dims_tuple, i);
    if (d == NULL) {
      Py_DECREF(pc);
      return NULL;
    }
    pc->dims[i] = PyLong_AsLongLong(d);
    Py_DECREF(d);
    if (pc->dims[i] == -1 && PyErr_Occurred()) {
      /* non-integer or overflow: returning with a live exception would be
       * a SystemError at the call boundary, and -1 dims would poison
       * later calls */
      Py_DECREF(pc);
      return NULL;
    }
    pc->grid_ptrs[i] = NULL;
  }
  if (grid_addrs != Py_None) {
    for (int i = 0; i < ndims; i++) {
      PyObject *a = PySequence_GetItem(grid_addrs, i);
      if (a == NULL) {
        Py_DECREF(pc);
        return NULL;
      }
      unsigned long long addr = PyLong_AsUnsignedLongLong(a);
      Py_DECREF(a);
      if (addr == (unsigned long long)-1 && PyErr_Occurred()) {
        Py_DECREF(pc);
        return NULL;
      }
      pc->grid_ptrs[i] = (const void *)(uintptr_t)addr;
    }
  }
  Py_INCREF(keep);
  pc->keep = keep;
  return (PyObject *)pc;
}

static PyMethodDef methods[] = {
    {"prepare", prepare, METH_VARARGS, "Build a PreparedCall"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_interpn_fastcall", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__interpn_fastcall(void) {
  if (PyType_Ready(&PreparedCallType) < 0) return NULL;
  return PyModule_Create(&moduledef);
}
