"""Build and load the CUDA kernels.

Every ``ops/csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``, then linked into one shared library with
a plain C interface (no PyTorch headers), which is loaded with ``ctypes``.
The build lives in ``<package>/build/<hash of sources and flags>/`` and is
made at first use, so a fresh checkout builds it on its first kernel call.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
_LIB_NAME = "libhds_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

#: C entry -> argtypes; every entry returns the cudaError_t of its launch
SIGNATURES = {
    # x, w, out, rows, hidden, eps, x_dtype, w_dtype, stream
    "hds_rms_norm": [_vp, _vp, _vp, _i, _i, _f, _i, _i, _vp],
    # q, k_pool, v_pool, tables, start, kv_len, out,
    # B, T, Hq, KV, D, P, NB, BS, scale, dtype, stream
    "hds_paged_attention": [_vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _vp],
}

#: dtype codes shared with the C entries (csrc/hds_common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    """C dtype code of a torch dtype."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


_lib = None
build_info = {"seconds": None, "dir": None, "log": ""}


def sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out_dir = _BUILD_ROOT / source_hash()
    lib = out_dir / _LIB_NAME
    build_info["dir"] = str(out_dir)
    if lib.exists():
        build_info["seconds"] = 0.0
        log = out_dir / "build.log"
        build_info["log"] = log.read_text() if log.exists() else ""
        return lib
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=_BUILD_ROOT, prefix=".tmp-"))
    try:
        procs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(obj.stem)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) +
                               ":\n" + "\n".join(logs))
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / _LIB_NAME),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError("link failed:\n" + "\n".join(logs))
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib.exists():     # not a concurrent build that won
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = (out_dir / "build.log").read_text()
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hds_error_string.argtypes = [ctypes.c_int]
        lib.hds_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a failed launch."""
    if err != 0:
        msg = load_library().hds_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
