// Native data-path kernels for the input pipeline: JPEG decode and bilinear
// resize. The training hot path feeds ~50+ images/sec/chip (see README perf
// table); on a pod the host-side decode/resize becomes the bottleneck, so these
// run in C++ (libjpeg + hand-rolled bilinear) instead of PIL. The reference
// relies on torchvision's native decoders for the same job
// (reference: src_distributed/utils.py:13-17).
//
// Build: see paella_tpu/data/native/__init__.py (g++ -O3 -shared, CPython API,
// no pybind11 dependency).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// decode_jpeg_rgb(data: bytes) -> (height, width, rgb_bytes)
PyObject* decode_jpeg_rgb(PyObject* /*self*/, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "invalid JPEG data");
    return nullptr;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, static_cast<const unsigned char*>(buf.buf), buf.len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  const int stride = w * 3;

  PyObject* out = PyBytes_FromStringAndSize(nullptr, static_cast<Py_ssize_t>(h) * stride);
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  unsigned char* dst = reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(out));

  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = dst + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  PyBuffer_Release(&buf);

  return Py_BuildValue("(iiN)", h, w, out);
}

// resize_bilinear_u8(rgb_bytes, h, w, out_h, out_w) -> rgb_bytes
// Half-pixel-centered bilinear on interleaved RGB u8 (matches PIL/torchvision
// 'bilinear' sampling convention closely enough for training crops).
PyObject* resize_bilinear_u8(PyObject* /*self*/, PyObject* args) {
  Py_buffer buf;
  int h, w, oh, ow;
  if (!PyArg_ParseTuple(args, "y*iiii", &buf, &h, &w, &oh, &ow)) return nullptr;
  if (static_cast<Py_ssize_t>(h) * w * 3 != buf.len) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "buffer size != h*w*3");
    return nullptr;
  }
  const unsigned char* src = static_cast<const unsigned char*>(buf.buf);

  PyObject* out = PyBytes_FromStringAndSize(nullptr, static_cast<Py_ssize_t>(oh) * ow * 3);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  unsigned char* dst = reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(out));

  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;

  Py_BEGIN_ALLOW_THREADS
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      const unsigned char* p00 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const unsigned char* p01 = src + (static_cast<size_t>(y0) * w + x1) * 3;
      const unsigned char* p10 = src + (static_cast<size_t>(y1) * w + x0) * 3;
      const unsigned char* p11 = src + (static_cast<size_t>(y1) * w + x1) * 3;
      unsigned char* o = dst + (static_cast<size_t>(y) * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        o[c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&buf);
  return out;
}

PyMethodDef methods[] = {
    {"decode_jpeg_rgb", decode_jpeg_rgb, METH_VARARGS,
     "decode_jpeg_rgb(data) -> (h, w, rgb_bytes)"},
    {"resize_bilinear_u8", resize_bilinear_u8, METH_VARARGS,
     "resize_bilinear_u8(rgb, h, w, out_h, out_w) -> rgb_bytes"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "paella_native",
                      "Native data-path kernels (JPEG decode, bilinear resize)",
                      -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_paella_native(void) { return PyModule_Create(&module); }
