/*
 * siftio -- the host data plane of cudasift_tpu_torch, in C++.
 *
 * The reference keeps its runtime layer in C++ (image container
 * cudaImage.cu, OpenCV file IO in mainSift.cpp, the 144-float SiftPoint
 * AoS record cudaSift.h:6-22). The port's compute path is PyTorch and CUDA;
 * the host-side codecs stay native:
 *
 *   - pgm_read / pgm_write: binary PGM (P5) codec into and out of float32
 *     buffers (the demo's inputs and its annotated output are PGM);
 *   - pack_siftpoints / unpack_siftpoints: convert between the SoA fields
 *     of SiftData and the reference's AoS SiftPoint binary layout
 *     (xpos, ypos, scale, sharpness, edgeness, orientation, score,
 *     ambiguity, match, match_xpos, match_ypos, match_error, subsampling,
 *     empty[3], data[128] = 144 floats), so descriptor sets can be
 *     exchanged with CudaSift-format dumps byte for byte.
 *
 * Plain CPython C API, no CUDA. Built with g++ at first use by
 * cudasift_tpu_torch/utils/native.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kPointFloats = 144;  // sizeof(SiftPoint)/4 in the reference
constexpr int kDescDim = 128;
constexpr int kHeaderFloats = kPointFloats - kDescDim;  // 16

// ---------------------------------------------------------------- PGM codec

PyObject* pgm_read(PyObject*, PyObject* args) {
  const char* path = nullptr;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
    return nullptr;
  }
  // Header: "P5" <ws> width <ws> height <ws> maxval <single ws>
  // Dimensions are bounded (<= 2^20 per axis) so a crafted header can
  // neither overflow the digit accumulator nor force a huge allocation.
  constexpr long kMaxDim = 1L << 20;
  auto next_token = [&](long* out) -> bool {
    int c;
    do {
      c = fgetc(f);
      if (c == '#') {  // comment to end of line
        while (c != '\n' && c != EOF) c = fgetc(f);
      }
    } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
    long v = 0;
    bool any = false;
    while (c >= '0' && c <= '9') {
      v = v * 10 + (c - '0');
      any = true;
      if (v > kMaxDim * 64) return false;  // way past any sane value
      c = fgetc(f);
    }
    *out = v;
    return any;
  };

  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 'P' || magic[1] != '5') {
    fclose(f);
    PyErr_Format(PyExc_ValueError, "%s: not a binary PGM (P5)", path);
    return nullptr;
  }
  long w = 0, h = 0, maxval = 0;
  if (!next_token(&w) || !next_token(&h) || !next_token(&maxval) || w <= 0 ||
      h <= 0 || w > kMaxDim || h > kMaxDim || maxval <= 0 || maxval > 65535) {
    fclose(f);
    PyErr_Format(PyExc_ValueError, "%s: bad PGM header", path);
    return nullptr;
  }

  const size_t npix = static_cast<size_t>(w) * static_cast<size_t>(h);
  const int bytes_per = maxval < 256 ? 1 : 2;
  std::vector<uint8_t> raw;
  try {
    raw.resize(npix * bytes_per);
  } catch (const std::bad_alloc&) {
    fclose(f);
    PyErr_Format(PyExc_MemoryError, "%s: image too large (%ldx%ld)", path, w,
                 h);
    return nullptr;
  }
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    PyErr_Format(PyExc_ValueError, "%s: truncated PGM payload", path);
    return nullptr;
  }
  fclose(f);

  PyObject* out = PyBytes_FromStringAndSize(nullptr, npix * sizeof(float));
  if (!out) return nullptr;
  float* dst = reinterpret_cast<float*>(PyBytes_AsString(out));
  if (bytes_per == 1) {
    for (size_t i = 0; i < npix; ++i) dst[i] = static_cast<float>(raw[i]);
  } else {
    for (size_t i = 0; i < npix; ++i) {
      dst[i] = static_cast<float>((raw[2 * i] << 8) | raw[2 * i + 1]);
    }
  }
  return Py_BuildValue("(Nll)", out, h, w);
}

PyObject* pgm_write(PyObject*, PyObject* args) {
  const char* path = nullptr;
  Py_buffer buf;
  long h = 0, w = 0;
  if (!PyArg_ParseTuple(args, "sy*ll", &path, &buf, &h, &w)) return nullptr;
  if (h <= 0 || w <= 0 || h > (1L << 20) || w > (1L << 20) ||
      buf.len < static_cast<Py_ssize_t>(sizeof(float)) * h * w) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError,
                    "bad dimensions or buffer smaller than h*w floats");
    return nullptr;
  }
  FILE* f = fopen(path, "wb");
  if (!f) {
    PyBuffer_Release(&buf);
    PyErr_Format(PyExc_OSError, "cannot open %s for writing", path);
    return nullptr;
  }
  fprintf(f, "P5\n%ld %ld\n255\n", w, h);
  const float* src = reinterpret_cast<const float*>(buf.buf);
  std::vector<uint8_t> row(w);
  for (long y = 0; y < h; ++y) {
    for (long x = 0; x < w; ++x) {
      float v = src[y * w + x];
      row[x] = v <= 0.f ? 0 : v >= 255.f ? 255 : static_cast<uint8_t>(v + 0.5f);
    }
    fwrite(row.data(), 1, w, f);
  }
  fclose(f);
  PyBuffer_Release(&buf);
  Py_RETURN_NONE;
}

// -------------------------------------------- SiftPoint AoS <-> SoA packing

// pack_siftpoints(header_bytes, desc_bytes, n) -> bytes of n*144 floats
// header: n*13 floats in field order (xpos..subsampling, match as float);
// desc: n*128 floats.
PyObject* pack_siftpoints(PyObject*, PyObject* args) {
  Py_buffer hdr, desc;
  long n = 0;
  if (!PyArg_ParseTuple(args, "y*y*l", &hdr, &desc, &n)) return nullptr;
  if (n < 0 || n > (1L << 24) ||
      hdr.len < static_cast<Py_ssize_t>(13 * n * sizeof(float)) ||
      desc.len < static_cast<Py_ssize_t>(kDescDim * n * sizeof(float))) {
    PyBuffer_Release(&hdr);
    PyBuffer_Release(&desc);
    PyErr_SetString(PyExc_ValueError, "input buffers too small");
    return nullptr;
  }
  PyObject* out =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)n * kPointFloats * 4);
  if (!out) {
    PyBuffer_Release(&hdr);
    PyBuffer_Release(&desc);
    return nullptr;
  }
  float* dst = reinterpret_cast<float*>(PyBytes_AsString(out));
  const float* hsrc = reinterpret_cast<const float*>(hdr.buf);
  const float* dsrc = reinterpret_cast<const float*>(desc.buf);
  std::memset(dst, 0, (size_t)n * kPointFloats * 4);
  for (long i = 0; i < n; ++i) {
    float* rec = dst + (size_t)i * kPointFloats;
    for (int j = 0; j < 8; ++j) rec[j] = hsrc[(size_t)j * n + i];
    // field 8 is the int32 match index (cudaSift.h:15)
    const float m = hsrc[8 * (size_t)n + i];
    const int32_t mi = static_cast<int32_t>(m);
    std::memcpy(rec + 8, &mi, 4);
    for (int j = 9; j < 13; ++j) rec[j] = hsrc[(size_t)j * n + i];
    std::memcpy(rec + kHeaderFloats, dsrc + (size_t)i * kDescDim,
                kDescDim * 4);
  }
  PyBuffer_Release(&hdr);
  PyBuffer_Release(&desc);
  return out;
}

// unpack_siftpoints(bytes, n) -> (header_bytes n*13 f32 SoA, desc_bytes)
PyObject* unpack_siftpoints(PyObject*, PyObject* args) {
  Py_buffer buf;
  long n = 0;
  if (!PyArg_ParseTuple(args, "y*l", &buf, &n)) return nullptr;
  if (n < 0 || n > (1L << 24) ||
      buf.len < static_cast<Py_ssize_t>((size_t)n * kPointFloats * 4)) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "buffer smaller than n records");
    return nullptr;
  }
  PyObject* hdr = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)n * 13 * 4);
  PyObject* desc =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)n * kDescDim * 4);
  if (!hdr || !desc) {
    Py_XDECREF(hdr);
    Py_XDECREF(desc);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  const float* src = reinterpret_cast<const float*>(buf.buf);
  float* hdst = reinterpret_cast<float*>(PyBytes_AsString(hdr));
  float* ddst = reinterpret_cast<float*>(PyBytes_AsString(desc));
  for (long i = 0; i < n; ++i) {
    const float* rec = src + (size_t)i * kPointFloats;
    for (int j = 0; j < 13; ++j) {
      if (j == 8) {
        int32_t mi;
        std::memcpy(&mi, rec + 8, 4);
        hdst[8 * (size_t)n + i] = static_cast<float>(mi);
      } else {
        hdst[(size_t)j * n + i] = rec[j];
      }
    }
    std::memcpy(ddst + (size_t)i * kDescDim, rec + kHeaderFloats,
                kDescDim * 4);
  }
  PyBuffer_Release(&buf);
  return Py_BuildValue("(NN)", hdr, desc);
}

PyMethodDef kMethods[] = {
    {"pgm_read", pgm_read, METH_VARARGS,
     "pgm_read(path) -> (float32 bytes, h, w)"},
    {"pgm_write", pgm_write, METH_VARARGS,
     "pgm_write(path, float32_bytes, h, w)"},
    {"pack_siftpoints", pack_siftpoints, METH_VARARGS,
     "pack_siftpoints(header_soa_bytes, desc_bytes, n) -> AoS bytes"},
    {"unpack_siftpoints", unpack_siftpoints, METH_VARARGS,
     "unpack_siftpoints(aos_bytes, n) -> (header_soa_bytes, desc_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_siftio",
    "Native IO and CudaSift-interop record packing for cudasift_tpu_torch.",
    -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__siftio(void) { return PyModule_Create(&kModule); }
