"""Build and load the CUDA kernels.

The sources in `csrc/` (`bitset.cu`, `segment_agg.cu`, `flash_attention.cu`,
`flash_attention_sm90.cu`, `embedding_bag.cu`) are compiled at first use
with `nvcc` for `sm_90a`, one compiler process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with `ctypes`. The library goes into `_build/` beside this file
(listed in `.gitignore`), named by a hash of every source and the flags, so
a changed source is always rebuilt and unchanged ones are built once per
checkout. Nothing is built when the module is imported.

`python -m repro_torch.kernels.build` (with `src` on PYTHONPATH, on a machine
with nvcc) times that build against one nvcc given every source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCES = tuple(CSRC / name for name in (
    "bitset.cu", "segment_agg.cu", "flash_attention.cu", "flash_attention_sm90.cu",
    "embedding_bag.cu"))
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless this set of sources' library exists. Each
    source compiles in its own nvcc process, all at once, then one nvcc
    links the objects. The compilers' output (with ptxas's register and
    spill report) lands beside the library in a `.log`. Raises if nvcc
    fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitset_spmm_launch.argtypes = [p, p, p, p, p, p, ll, ll, ll, i, i, p]
    lib.bitset_spmm_launch.restype = i
    lib.bitset_wave_launch.argtypes = [
        p, p, p, p, p, i, p, i, p, p, p, ll, ll, ll, i, i, p]
    lib.bitset_wave_launch.restype = i
    lib.segment_agg_launch.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.segment_agg_launch.restype = i
    lib.flash_attention_launch.argtypes = [  # d, then dv
        p, p, p, p, ll, i, i, i, i, i, ctypes.POINTER(ll), i, i, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_bf16_launch.argtypes = [  # d, dv, then the kv tile
        p, p, p, p, ll, i, i, i, i, i, i, ctypes.POINTER(ll), i, i, i, p]
    lib.flash_attention_bf16_launch.restype = i
    lib.embedding_bag_launch.argtypes = [p, p, p, p, ll, i, i, ll, i, i, i, p]
    lib.embedding_bag_launch.restype = i
    lib.bitset_error_string.argtypes = [i]
    lib.bitset_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library().bitset_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")


def compare_builds(reps: int = 2) -> dict:
    """Seconds of `build` (one nvcc per source, started together) and of one
    nvcc compiling and linking every source, each into a fresh directory
    under `_build/`, the two alternating in order over `reps` rounds."""
    home = BUILD_DIR
    home.mkdir(parents=True, exist_ok=True)

    def one_nvcc(tmp: Path) -> None:
        subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        str(tmp / "one.so"), *map(str, SOURCES)],
                       check=True, capture_output=True)

    def parallel(tmp: Path) -> None:
        global BUILD_DIR
        BUILD_DIR = tmp
        try:
            build()
        finally:
            BUILD_DIR = home

    seconds = {"parallel_s": [], "one_nvcc_s": []}
    for r in range(reps):
        runs = [("parallel_s", parallel), ("one_nvcc_s", one_nvcc)]
        for name, fn in (runs if r % 2 == 0 else runs[::-1]):
            with tempfile.TemporaryDirectory(dir=home) as tmp:
                t0 = time.perf_counter()
                fn(Path(tmp))
                seconds[name].append(time.perf_counter() - t0)
    return seconds


if __name__ == "__main__":
    print(json.dumps(compare_builds()))
