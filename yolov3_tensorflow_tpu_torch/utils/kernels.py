"""Build the package's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C launcher and is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/torch_kernels/lib<name>_<hash>.so` at the
repository root, where <hash> covers the source and the flags: a changed
source builds anew, an unchanged one loads the existing library. No PyTorch
headers are compiled, so a build takes seconds.

`--fmad=false` keeps nvcc from contracting a multiply and an add into one
FMA: the kernels' float arithmetic must round exactly as their plain
PyTorch versions do (IoU>t decisions near t must not flip).

Host libraries (`csrc/<name>.cc`, a plain C interface for ctypes, such as
`utils/native.py`'s) take the same route through the host's C++ compiler
(`$CXX`, else `g++`) with HOST_FLAGS, into the same directory, hashed over
the source, the compiler's path and the flags. `-ffp-contract=off` is
`--fmad=false`'s counterpart: the library rounds as its numpy oracles do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build_kernels(*names: str, defines: Tuple[str, ...] = ()
                  ) -> Dict[str, Path]:
    """Compile csrc/<name>.cu for each name whose library does not exist
    yet: one nvcc per source, all started together, each one's output
    (register and shared-memory use, from -Xptxas=-v) kept in
    `<library>.log`. `defines` are preprocessor macros for every source
    (an instrumented build, such as K1_PHASES for scripts/k1_phases.py);
    they are part of the library's name. Waits for every compiler it
    started, then raises if any failed. Returns each name's library
    path."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    outs: Dict[str, Path] = {}
    started = []
    for name in names:
        src = (CSRC / f"{name}.cu").read_bytes()
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
        out = outs[name] = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".so.log")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def nvcc_version() -> str:
    """The installed nvcc's version (V12.8.93 of `nvcc --version`'s
    "release 12.8, V12.8.93")."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    release = out.rsplit("release", 1)[-1].splitlines()[0]
    return release.split(",")[-1].strip()


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("cuobjdump")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        return str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit "
                       "(on PATH or under CUDA_HOME)")


def _sass(lib: Path) -> str:
    return subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_opcode(line: str) -> Optional[str]:
    """The opcode of a line of `cuobjdump -sass` that holds an instruction,
    without its predicate and modifiers (HGMMA of `@P0 HGMMA.64x128x16 ...`);
    None for any other line."""
    words = [w for w in line.split("*/", 1)[-1].split()
             if not w.startswith("@")]              # drop a predicate
    return words[0].split(".")[0] if "*/" in line and words else None


def sass_counts(lib: Path, opcodes=("HGMMA", "HMMA")) -> Dict[str, int]:
    """How many instructions of each opcode the library's machine code
    (`cuobjdump -sass`) holds: HGMMA is Hopper's warpgroup product (wgmma),
    HMMA the per-warp one (mma.sync)."""
    heads = [sass_opcode(line) for line in _sass(lib).splitlines()]
    return {op: heads.count(op) for op in opcodes}


def sass_functions(lib: Path) -> Dict[str, List[str]]:
    """Each kernel's machine code in the library (`cuobjdump -sass`), by
    the name cuobjdump gives it: its lines in order (addresses,
    instructions and their encodings) with the spaces squeezed, so that
    two builds of one kernel compare equal where their code is."""
    out: Dict[str, List[str]] = {}
    code = None
    for line in _sass(lib).splitlines():
        if "Function :" in line:
            code = out.setdefault(line.split("Function :", 1)[1].strip(), [])
        elif code is not None and "*/" in line:
            code.append(" ".join(line.split()))
    return out


def build_kernel(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """`build_kernels` for one source. Returns the library's path."""
    return build_kernels(name, defines=defines)[name]


def host_compiler(name: Optional[str] = None) -> str:
    """The path of the host C++ compiler `name` (default: `$CXX` where
    set, else `g++`). Raises, naming the compiler, where it is not
    found."""
    name = name or os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found (set CXX "
                           f"to a C++17 compiler, or put g++ on PATH)")
    return found


def build_host_library(name: str, compiler: Optional[str] = None) -> Path:
    """Compile csrc/<name>.cc with the host compiler (`host_compiler
    (compiler)`) into `build/torch_kernels/lib<name>_<hash>.so` unless
    that library exists. Raises, naming the compiler and its output, where
    the build fails. Returns the library's path."""
    cxx = host_compiler(compiler)
    src = CSRC / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        (cxx,) + HOST_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {name}.cc ({proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)    # atomic: a concurrent build never sees half
    return out


@functools.lru_cache(maxsize=None)
def load_kernel(name: str, group: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per
    process. The sources named in `group` are built in the same
    `build_kernels` call, so kernels used together compile at once."""
    names = group if name in group else (name, *group)
    return ctypes.CDLL(str(build_kernels(*names)[name]))
