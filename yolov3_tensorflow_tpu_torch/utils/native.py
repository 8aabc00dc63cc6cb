"""ctypes binding for the host postprocess library, `csrc/postprocess.cc`
(counterpart of `yolov3_tensorflow_tpu/utils/native.py`).

The library is built at first use by the host-compiler route of
`utils/kernels.py` (`$CXX` or `g++`) into `build/torch_kernels/`, never
into the JAX package's `native/`. `nms`, `nms_multiclass` and `iou_matrix`
keep the JAX functions' contracts, but where the library cannot be built
or loaded they raise, naming the compiler: there is no numpy fallback
inside them. `available()` says whether the library loads.

`evaluation/metrics.py:iou_matrix` prefers its `iou_matrix` where
`available()`, as the JAX package's does. `python -m
yolov3_tensorflow_tpu_torch.utils.native` builds it and checks it against
the numpy oracles (`ops.nms.py_nms`, `ops.nms.cpu_nms`,
`evaluation.metrics._iou_matrix`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from yolov3_tensorflow_tpu_torch.utils import kernels

SOURCE = "postprocess"                 # csrc/postprocess.cc


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


@functools.lru_cache(maxsize=None)
def _open(compiler: str) -> ctypes.CDLL:
    """Build (once per compiler name) and load the library, with its
    functions' argument types."""
    path = kernels.build_host_library(SOURCE, compiler)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.yolo_nms.restype = ctypes.c_int32
    lib.yolo_nms.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_int32,
                             ctypes.c_float, ctypes.c_float, i32p]
    lib.yolo_nms_multiclass.restype = ctypes.c_int32
    lib.yolo_nms_multiclass.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, f32p, f32p, i32p]
    lib.yolo_iou_matrix.restype = None
    lib.yolo_iou_matrix.argtypes = [f32p, ctypes.c_int32, f32p,
                                    ctypes.c_int32, ctypes.c_float, f32p]
    return lib


def library_path() -> Path:
    """Build the library if needed (the compiler `$CXX` names, else g++)
    and return its path. Raises RuntimeError, naming the compiler, where
    it is missing or fails."""
    return kernels.build_host_library(SOURCE, _compiler())


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call for the compiler that
    `$CXX` names (else g++) and kept; raises where it cannot be built or
    loaded (a failure is not kept: the next call tries again)."""
    return _open(_compiler())


def available() -> bool:
    """Whether the library builds and loads here with the compiler that
    `$CXX` names (else g++). Each compiler is tried once a process and its
    answer kept, a failure too, so that a caller that asks before every
    call (`evaluation.metrics.iou_matrix`) starts no second build."""
    return _loads(_compiler())


@functools.lru_cache(maxsize=None)
def _loads(compiler: str) -> bool:
    try:
        _open(compiler)
    except RuntimeError:
        return False
    return True


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def nms(boxes: np.ndarray, scores: np.ndarray, max_out: int = 50,
        iou_thresh: float = 0.5, pixel_offset: float = 0.0) -> list:
    """Greedy NMS over one score vector (boxes [n, 4] xyxy, scores [n]):
    the kept indices, score-descending, ties to the lower index; the
    contract of `ops.nms.py_nms` (its `offset` is `pixel_offset`)."""
    lib = load()
    b, s = _f32(boxes), _f32(scores)
    keep = np.empty(max(max_out, 0), np.int32)
    n = lib.yolo_nms(_ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float),
                     len(s), max_out, iou_thresh, pixel_offset,
                     _ptr(keep, ctypes.c_int32))
    return keep[:n].tolist()


def nms_multiclass(boxes: np.ndarray, scores: np.ndarray, num_classes: int,
                   max_per_class: int = 50, score_thresh: float = 0.5,
                   iou_thresh: float = 0.5
                   ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
                              Optional[np.ndarray]]:
    """Per-class NMS over a dense [n, num_classes] score matrix; the
    contract of `ops.nms.cpu_nms`: (boxes [N, 4], scores [N], labels [N]),
    classes in order, or (None, None, None)."""
    lib = load()
    b = _f32(np.reshape(boxes, (-1, 4)))
    s = _f32(np.reshape(scores, (-1, num_classes)))
    cap = num_classes * max_per_class
    out_b = np.empty((cap, 4), np.float32)
    out_s = np.empty(cap, np.float32)
    out_l = np.empty(cap, np.int32)
    total = lib.yolo_nms_multiclass(
        _ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float), b.shape[0],
        num_classes, max_per_class, score_thresh, iou_thresh,
        _ptr(out_b, ctypes.c_float), _ptr(out_s, ctypes.c_float),
        _ptr(out_l, ctypes.c_int32))
    if total == 0:
        return None, None, None
    return out_b[:total].copy(), out_s[:total].copy(), out_l[:total].copy()


def iou_matrix(a: np.ndarray, b: np.ndarray,
               pixel_offset: float = 0.0) -> np.ndarray:
    """Pairwise IoU [n, 4] x [m, 4] xyxy -> [n, m] float32."""
    lib = load()
    aa = _f32(np.reshape(a, (-1, 4)))
    bb = _f32(np.reshape(b, (-1, 4)))
    out = np.empty((aa.shape[0], bb.shape[0]), np.float32)
    lib.yolo_iou_matrix(_ptr(aa, ctypes.c_float), aa.shape[0],
                        _ptr(bb, ctypes.c_float), bb.shape[0], pixel_offset,
                        _ptr(out, ctypes.c_float))
    return out


def self_test(seed: int = 0) -> None:
    """The library against the numpy oracles on seeded boxes: NMS at both
    pixel offsets equal to `py_nms`, per-class NMS to `cpu_nms`, the IoU
    matrix to `evaluation.metrics._iou_matrix`, bit for bit. Raises
    AssertionError on a difference."""
    from yolov3_tensorflow_tpu_torch.evaluation.metrics import \
        _iou_matrix as numpy_iou
    from yolov3_tensorflow_tpu_torch.ops.nms import cpu_nms, py_nms
    rng = np.random.default_rng(seed)

    def boxes(n, span):
        xy = rng.uniform(0, span, (n, 2))
        wh = rng.uniform(5, 120, (n, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def same(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"{what} differs from its numpy oracle")

    for offset in (0.0, 1.0):
        bx = boxes(120, 150.0)
        sc = rng.uniform(0, 1, 120).astype(np.float32)
        same(nms(bx, sc, 120, 0.5, offset) == py_nms(bx, sc, 120, 0.5,
                                                     offset),
             f"nms at pixel offset {offset}")
    bx = boxes(200, 300.0)
    sc = rng.uniform(0, 0.9, (200, 6)).astype(np.float32)
    got = nms_multiclass(bx, sc, 6, 20, 0.4, 0.5)
    want = cpu_nms(bx, sc, 6, 20, 0.4, 0.5)
    same(all(np.array_equal(g, w) for g, w in zip(got, want)),
         "nms_multiclass")
    a, b = boxes(150, 400.0), boxes(50, 400.0)
    same(np.array_equal(iou_matrix(a, b), numpy_iou(a, b)), "iou_matrix")


def main() -> int:
    try:
        path = library_path()
        load()
    except RuntimeError as e:
        print(f"native library: unavailable: {e}")
        return 1
    print(f"native library: {path}")
    self_test()
    print("self-test: NMS == py_nms (offsets 0 and 1), nms_multiclass == "
          "cpu_nms, iou_matrix == the numpy IoU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
