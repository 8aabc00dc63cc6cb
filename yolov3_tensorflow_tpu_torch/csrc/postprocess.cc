// Host-side detection postprocess (C++), the port's copy of the JAX
// package's native/postprocess.cc: exact greedy NMS, per-class NMS over a
// dense score matrix, and the pairwise IoU matrix, with a plain C ABI for
// ctypes (yolov3_tensorflow_tpu_torch/utils/native.py). Everything below
// this comment equals the original (tests/test_torch_host_helpers.py).
//
// Build: python -m yolov3_tensorflow_tpu_torch.utils.native (the host
// compiler route of utils/kernels.py, into build/torch_kernels/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline float box_area(const float* b, float offset) {
  const float w = b[2] - b[0] + offset;
  const float h = b[3] - b[1] + offset;
  return (w > 0.f && h > 0.f) ? w * h : 0.f;
}

inline float pair_iou(const float* a, const float* b, float offset) {
  const float x0 = std::max(a[0], b[0]);
  const float y0 = std::max(a[1], b[1]);
  const float x1 = std::min(a[2], b[2]);
  const float y1 = std::min(a[3], b[3]);
  const float iw = x1 - x0 + offset;
  const float ih = y1 - y0 + offset;
  if (iw <= 0.f || ih <= 0.f) return 0.f;
  const float inter = iw * ih;
  return inter / (box_area(a, offset) + box_area(b, offset) - inter);
}

}  // namespace

extern "C" {

// Greedy NMS over one score vector.
//   boxes:  [n, 4] xyxy row-major
//   scores: [n]
//   keep_out: caller-allocated [max_out] int32; returns number kept.
// Exact semantics of the reference's numpy py_nms / TF C++ NMS: process in
// score-descending order (stable ties by index), keep a box iff no
// already-kept box overlaps it with IoU > iou_thresh.
int32_t yolo_nms(const float* boxes, const float* scores, int32_t n,
                 int32_t max_out, float iou_thresh, float pixel_offset,
                 int32_t* keep_out) {
  if (n <= 0 || max_out <= 0) return 0;
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return scores[a] > scores[b];
  });

  std::vector<char> suppressed(n, 0);
  int32_t kept = 0;
  for (int32_t oi = 0; oi < n && kept < max_out; ++oi) {
    const int32_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int32_t oj = oi + 1; oj < n; ++oj) {
      const int32_t j = order[oj];
      if (suppressed[j]) continue;
      if (pair_iou(bi, boxes + 4 * j, pixel_offset) > iou_thresh)
        suppressed[j] = 1;
    }
  }
  return kept;
}

// Per-class NMS over a dense [n, num_classes] score matrix
// (reference cpu_nms semantics, nms_utils.py:91-123): per class, filter by
// score_thresh, greedy-NMS, cap at max_per_class; concatenate classes.
// Outputs (caller-allocated, capacity num_classes * max_per_class):
//   out_boxes [cap, 4], out_scores [cap], out_labels [cap].
// Returns total detections written.
int32_t yolo_nms_multiclass(const float* boxes, const float* scores,
                            int32_t n, int32_t num_classes,
                            int32_t max_per_class, float score_thresh,
                            float iou_thresh, float* out_boxes,
                            float* out_scores, int32_t* out_labels) {
  if (n <= 0 || num_classes <= 0 || max_per_class <= 0) return 0;
  std::vector<float> cls_boxes;
  std::vector<float> cls_scores;
  std::vector<int32_t> keep(max_per_class);
  int32_t total = 0;

  for (int32_t c = 0; c < num_classes; ++c) {
    cls_boxes.clear();
    cls_scores.clear();
    for (int32_t i = 0; i < n; ++i) {
      const float s = scores[i * num_classes + c];
      if (s >= score_thresh) {
        const float* b = boxes + 4 * i;
        cls_boxes.insert(cls_boxes.end(), b, b + 4);
        cls_scores.push_back(s);
      }
    }
    const int32_t m = static_cast<int32_t>(cls_scores.size());
    if (m == 0) continue;
    const int32_t kept = yolo_nms(cls_boxes.data(), cls_scores.data(), m,
                                  max_per_class, iou_thresh, 0.f,
                                  keep.data());
    for (int32_t k = 0; k < kept; ++k) {
      const int32_t idx = keep[k];
      std::memcpy(out_boxes + 4 * total, cls_boxes.data() + 4 * idx,
                  4 * sizeof(float));
      out_scores[total] = cls_scores[idx];
      out_labels[total] = c;
      ++total;
    }
  }
  return total;
}

// Pairwise IoU matrix: a [n, 4] x b [m, 4] -> out [n, m] (row-major).
// Equivalent of the numpy broadcast in eval_utils.py:13-45.
void yolo_iou_matrix(const float* a, int32_t n, const float* b, int32_t m,
                     float pixel_offset, float* out) {
  for (int32_t i = 0; i < n; ++i) {
    const float* bi = a + 4 * i;
    for (int32_t j = 0; j < m; ++j) {
      out[i * m + j] = pair_iou(bi, b + 4 * j, pixel_offset);
    }
  }
}

}  // extern "C"
