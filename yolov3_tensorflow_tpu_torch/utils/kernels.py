"""Build the package's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C launcher and is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/torch_kernels/lib<name>_<hash>.so` at the
repository root, where <hash> covers the source and the flags: a changed
source builds anew, an unchanged one loads the existing library. No PyTorch
headers are compiled, so a build takes seconds.

`--fmad=false` keeps nvcc from contracting a multiply and an add into one
FMA: the kernels' float arithmetic must round exactly as their plain
PyTorch versions do (IoU>t decisions near t must not flip).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build_kernels(*names: str) -> Dict[str, Path]:
    """Compile csrc/<name>.cu for each name whose library does not exist
    yet: one nvcc per source, all started together, each one's output
    (register and shared-memory use, from -Xptxas=-v) kept in
    `<library>.log`. Waits for every compiler it started, then raises if
    any failed. Returns each name's library path."""
    outs: Dict[str, Path] = {}
    started = []
    for name in names:
        src = (CSRC / f"{name}.cu").read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = outs[name] = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".so.log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        started.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in started:
        if proc.wait() != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{log.read_text()[-4000:]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("cuobjdump")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        return str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit "
                       "(on PATH or under CUDA_HOME)")


def sass_counts(lib: Path, opcodes=("HGMMA", "HMMA")) -> Dict[str, int]:
    """How many instructions of each opcode the library's machine code
    (`cuobjdump -sass`) holds: HGMMA is Hopper's warpgroup product (wgmma),
    HMMA the per-warp one (mma.sync)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    heads = []
    for line in sass.splitlines():
        words = [w for w in line.split("*/", 1)[-1].split()
                 if not w.startswith("@")]          # drop a predicate
        if "*/" in line and words:
            heads.append(words[0].split(".")[0])
    return {op: heads.count(op) for op in opcodes}


def build_kernel(name: str) -> Path:
    """`build_kernels` for one source. Returns the library's path."""
    return build_kernels(name)[name]


@functools.lru_cache(maxsize=None)
def load_kernel(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per
    process."""
    return ctypes.CDLL(str(build_kernel(name)))
