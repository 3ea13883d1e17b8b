/* gridbin.c — native observation->grid binning kernels.
 *
 * Host-side hot loop of the data-prep layer: snapping millions of raw
 * observations to a regular lat/lon grid, computing row-major gridbox
 * indices, and reducing per-gridbox means/counts. The device consumes the
 * (idx, mean) pairs; this stage is pure pointer-chasing host work where
 * a C loop beats vectorised numpy by avoiding temporaries and passes.
 *
 * Exposed via the CPython C API (no pybind11 dependency):
 *   snap_to_grid(lat, lon, lat0, lat_step, n_lat, lon0, lon_step, n_lon)
 *       -> int64 gridbox index per observation (C-order ravel)
 *   bin_mean(idx, values, n_boxes) -> (unique_idx, means, counts)
 *
 * Falls back to the numpy implementation in gridbin.py when the
 * extension is not built (build: python setup_native.py build_ext).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* nearest gridpoint on a regular axis: round((x - x0) / step), clamped */
static inline int64_t snap_axis(double x, double x0, double step, int64_t n)
{
    double pos = (x - x0) / step;
    int64_t i = (int64_t)(pos + (pos >= 0 ? 0.5 : -0.5));
    if (i < 0)
        i = 0;
    if (i >= n)
        i = n - 1;
    return i;
}

static PyObject *py_snap_to_grid(PyObject *self, PyObject *args)
{
    Py_buffer lat_buf, lon_buf;
    double lat0, lat_step, lon0, lon_step;
    Py_ssize_t n_lat, n_lon;

    if (!PyArg_ParseTuple(args, "y*y*ddnddn", &lat_buf, &lon_buf, &lat0,
                          &lat_step, &n_lat, &lon0, &lon_step, &n_lon))
        return NULL;

    if (lat_buf.len != lon_buf.len ||
        lat_buf.len % (Py_ssize_t)sizeof(double) != 0) {
        PyBuffer_Release(&lat_buf);
        PyBuffer_Release(&lon_buf);
        PyErr_SetString(PyExc_ValueError,
                        "lat/lon must be equal-length float64 buffers");
        return NULL;
    }

    Py_ssize_t n = lat_buf.len / (Py_ssize_t)sizeof(double);
    const double *lat = (const double *)lat_buf.buf;
    const double *lon = (const double *)lon_buf.buf;

    PyObject *out = PyBytes_FromStringAndSize(NULL,
                                              n * (Py_ssize_t)sizeof(int64_t));
    if (!out) {
        PyBuffer_Release(&lat_buf);
        PyBuffer_Release(&lon_buf);
        return NULL;
    }
    int64_t *idx = (int64_t *)PyBytes_AsString(out);

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t k = 0; k < n; k++) {
        int64_t i = snap_axis(lat[k], lat0, lat_step, (int64_t)n_lat);
        int64_t j = snap_axis(lon[k], lon0, lon_step, (int64_t)n_lon);
        idx[k] = i * (int64_t)n_lon + j; /* C-order ravel */
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&lat_buf);
    PyBuffer_Release(&lon_buf);
    return out;
}

static PyObject *py_bin_mean(PyObject *self, PyObject *args)
{
    Py_buffer idx_buf, val_buf;
    Py_ssize_t n_boxes;

    if (!PyArg_ParseTuple(args, "y*y*n", &idx_buf, &val_buf, &n_boxes))
        return NULL;

    Py_ssize_t n = idx_buf.len / (Py_ssize_t)sizeof(int64_t);
    if (val_buf.len != n * (Py_ssize_t)sizeof(double)) {
        PyBuffer_Release(&idx_buf);
        PyBuffer_Release(&val_buf);
        PyErr_SetString(PyExc_ValueError, "idx/values length mismatch");
        return NULL;
    }
    const int64_t *idx = (const int64_t *)idx_buf.buf;
    const double *val = (const double *)val_buf.buf;

    double *sums = (double *)calloc((size_t)n_boxes, sizeof(double));
    int64_t *counts = (int64_t *)calloc((size_t)n_boxes, sizeof(int64_t));
    if (!sums || !counts) {
        free(sums);
        free(counts);
        PyBuffer_Release(&idx_buf);
        PyBuffer_Release(&val_buf);
        return PyErr_NoMemory();
    }

    int bad = 0;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t k = 0; k < n; k++) {
        int64_t b = idx[k];
        if (b < 0 || b >= (int64_t)n_boxes) {
            bad = 1;
            break;
        }
        sums[b] += val[k];
        counts[b] += 1;
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&idx_buf);
    PyBuffer_Release(&val_buf);
    if (bad) {
        free(sums);
        free(counts);
        PyErr_SetString(PyExc_ValueError, "gridbox index out of range");
        return NULL;
    }

    /* compact to occupied boxes */
    Py_ssize_t n_occ = 0;
    for (Py_ssize_t b = 0; b < n_boxes; b++)
        if (counts[b] > 0)
            n_occ++;

    PyObject *uidx_b =
        PyBytes_FromStringAndSize(NULL, n_occ * (Py_ssize_t)sizeof(int64_t));
    PyObject *mean_b =
        PyBytes_FromStringAndSize(NULL, n_occ * (Py_ssize_t)sizeof(double));
    PyObject *cnt_b =
        PyBytes_FromStringAndSize(NULL, n_occ * (Py_ssize_t)sizeof(int64_t));
    if (!uidx_b || !mean_b || !cnt_b) {
        Py_XDECREF(uidx_b);
        Py_XDECREF(mean_b);
        Py_XDECREF(cnt_b);
        free(sums);
        free(counts);
        return NULL;
    }
    int64_t *uidx = (int64_t *)PyBytes_AsString(uidx_b);
    double *mean = (double *)PyBytes_AsString(mean_b);
    int64_t *cnt = (int64_t *)PyBytes_AsString(cnt_b);

    Py_ssize_t w = 0;
    for (Py_ssize_t b = 0; b < n_boxes; b++) {
        if (counts[b] > 0) {
            uidx[w] = b;
            mean[w] = sums[b] / (double)counts[b];
            cnt[w] = counts[b];
            w++;
        }
    }
    free(sums);
    free(counts);

    PyObject *result = PyTuple_Pack(3, uidx_b, mean_b, cnt_b);
    Py_DECREF(uidx_b);
    Py_DECREF(mean_b);
    Py_DECREF(cnt_b);
    return result;
}

static PyMethodDef GridbinMethods[] = {
    {"snap_to_grid", py_snap_to_grid, METH_VARARGS,
     "Snap observations to nearest regular-grid boxes (C-order index)."},
    {"bin_mean", py_bin_mean, METH_VARARGS,
     "Per-gridbox mean/count reduction over observation values."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef gridbinmodule = {
    PyModuleDef_HEAD_INIT, "_gridbin",
    "Native observation->grid binning kernels.", -1, GridbinMethods};

PyMODINIT_FUNC PyInit__gridbin(void) { return PyModule_Create(&gridbinmodule); }
