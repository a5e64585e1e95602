"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on its own by `nvcc` into a shared
library with a plain C interface and loaded with ctypes — no PyTorch
headers, so a build takes seconds. Libraries land in the package's
`build/` directory (git-ignored), named by a hash of the sources and
flags, and are built at first use, never at import: `import
circuitvision_tpu_torch` works on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024
#: kernel sources; each becomes lib<name>-<hash>.so
SOURCES = ("mlp_block", "window_attn", "refinement", "global_attn", "flash_attn", "flash_bwd",
           "morphology", "fused_ln", "launch_floor")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of the exported launchers
SIGNATURES = {
    "mlp_block": {
        "cv_mlp_block_f32": [_P] * 9 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
        "cv_mlp_block_bf16": [_P] * 10 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "cv_mlp_ln_smem": [_I],
        "cv_mlp_gemm_smem": [_I],
    },
    "window_attn": {
        "cv_window_attn_f32": [_P] * 9 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "cv_window_attn_bf16": [_P] * 8 + [_I] * 4 + [_F, _P],
        "cv_qpool_attn_f32": [_P] * 11 + [_I] * 5 + [_F] + [_I] + [_P],
        "cv_qpool_attn_bf16": [_P] * 11 + [_I] * 5 + [_F, _P],
        "cv_window_attn_smem": [_I, _I, _I],
        "cv_window_f32_attn_smem": [_I],
        "cv_qpool_attn_smem": [_I] * 4,
        "cv_qpool_f32_attn_smem": [_I],
    },
    "refinement": {
        "cv_refinement": [_P] * 12 + [_I] * 4 + [_P],
    },
    "global_attn": {
        "cv_ln_heads_f32": [_P] * 6 + [_I] * 6 + [_F, _P],
        "cv_ln_heads_bf16": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        "cv_proj_res_f32": [_P] * 5 + [_I] * 6 + [_P],
        "cv_proj_res_bf16": [_P] * 5 + [_I] * 8 + [_P],
        "cv_ln_heads_smem": [_I],
        "cv_proj_res_smem": [_I],
        "cv_ln_heads_ln_smem": [_I],
        "cv_ln_heads_gemm_smem": [_I],
    },
    "flash_attn": {
        "cv_flash_attn_f32": [_P] * 4 + [_I] * 5 + [_F, _P],
        "cv_flash_attn_bf16": [_P] * 4 + [_I] * 9 + [_F, _P],
        "cv_flash_attn_bf16_smem": [_I] * 4,
        "cv_flash_attn_lse_bf16": [_P] * 5 + [_I] * 8 + [_F, _P],
        "cv_flash_attn_lse_f32": [_P] * 5 + [_I] * 4 + [_F, _P],
    },
    "flash_bwd": {
        "cv_flash_bwd_dq": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
        "cv_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
        "cv_flash_bwd_bf16_smem": [_I],
    },
    "morphology": {
        "cv_enhance_lines": [_P, _P, _I, _I] + [_F] * 5 + [_P],
    },
    "launch_floor": {
        "cv_empty_kernel": [_P],
    },
    "fused_ln": {
        "cv_fused_layernorm": [_P] * 4 + [_I, _I, _F, _I, _P],
        "cv_fused_add_layernorm": [_P] * 6 + [_I, _I, _F, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel could not be built or launched, or was given a tensor it
    does not take. The pipeline's degradation ladders never swallow it."""


#: words of torch's RuntimeErrors from the CUDA runtime, cuDNN and cuBLAS
#: ("CUDA error: ...", "cuDNN error: CUDNN_STATUS_...", "CUBLAS_STATUS_...")
_DEVICE_ERROR_WORDS = ("CUDA", "cuDNN", "CUDNN_STATUS", "cuBLAS", "CUBLAS_STATUS")


def is_device_fault(exc: BaseException) -> bool:
    """Kernel faults and CUDA, cuDNN and cuBLAS errors, which no
    degradation ladder may hide."""
    accel = getattr(torch, "AcceleratorError", None)
    return (
        isinstance(exc, KernelError)
        or (accel is not None and isinstance(exc, accel))
        or (isinstance(exc, RuntimeError) and any(w in str(exc) for w in _DEVICE_ERROR_WORDS))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source that has no current library, one nvcc per
    source, all started together. Returns name → library path."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = []
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_longlong if fn.endswith("_smem") else ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the card that holds t."""
    index = t.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def empty_kernel(device: torch.device | str = "cuda") -> None:
    """Launch csrc/launch_floor.cu's empty kernel on the current stream of
    `device`: the card's own cost of a launch, the floor under every
    kernel's time."""
    err = library("launch_floor").cv_empty_kernel(torch.cuda.current_stream(device).cuda_stream)
    check(err, "empty_kernel")


def dtype_code(t: torch.Tensor) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise KernelError(f"unsupported dtype {t.dtype}; kernels take float32 or bfloat16")
    return codes[t.dtype]


def check_ln_params(what: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    """LayerNorm scale and bias: float32 (whatever x's dtype, as flax keeps
    its parameters), contiguous, of shape (x.shape[-1],), on x's device."""
    for t in (scale, bias):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous() \
                or t.shape != (x.shape[-1],):
            raise KernelError(f"{what}: LayerNorm parameters must be contiguous float32 of "
                              f"shape ({x.shape[-1]},) on {x.device}; got {t.dtype} "
                              f"{tuple(t.shape)} on {t.device}")


def check_operands(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """All operands on x's CUDA device, contiguous, of x's dtype."""
    dtype_code(x)
    for t in (x, *others):
        if not t.is_cuda or t.device != x.device:
            raise KernelError(f"{what}: operand on {t.device}, expected {x.device}")
        if t.dtype != x.dtype:
            raise KernelError(f"{what}: operand dtype {t.dtype} != {x.dtype}")
        if not t.is_contiguous():
            raise KernelError(f"{what}: operand of shape {tuple(t.shape)} is not contiguous")


def check_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """A kernel has no backward: under grad mode, an operand that requires
    grad would leave everything upstream of it without a gradient, and
    nothing would say so. Raise instead (FlashAttention is the one kernel
    with a backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelError(f"{what}: an operand requires grad, and the kernel has no backward; "
                          "run it under torch.no_grad() or take the module path "
                          "(models/sam2/hiera.force_fused)")


def check_aligned(what: str, *tensors: torch.Tensor, align: int = 16) -> None:
    """Operands that a kernel copies in 16-byte pieces start on a 16-byte
    boundary."""
    for t in tensors:
        if t.data_ptr() % align:
            raise KernelError(f"{what}: operand of shape {tuple(t.shape)} is not "
                              f"{align}-byte aligned")
