"""Build, load and launch the port's hand-written CUDA kernels.

Route: each `csrc/<name>.cu` exposes a plain C interface and is compiled by
nvcc for sm_90a into its own shared library, loaded with ctypes (no
PyTorch headers, so a build takes seconds). Libraries go to
`build/torch_kernels/` beside the package, keyed by a hash of the sources
and flags, so a fresh checkout builds them at first use and a changed
source is rebuilt. A missing nvcc or a failed build raises with the
compiler's output; nothing falls back to the plain PyTorch versions.

Each kernel wrapper (ops/scan.py, ops/expand.py, ops/composite.py,
ops/segreduce.py)
dispatches on the device of its tensors: CPU tensors run the plain
PyTorch version beside it, CUDA tensors launch the kernel on the current
stream or raise. The wrapper adds one to its Kernel's `launches` where it
launches, and nowhere else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -fmad=false: no multiply-add contraction, so every float product and sum
# rounds as in the plain PyTorch versions (one op at a time) and the
# compositor's termination test sees the same transmittance.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, PATH and the "
        "default toolkit location): the CUDA kernels cannot be built")


@dataclasses.dataclass(eq=False)
class Kernel:
    """One CUDA source and its C entry points.

    name: the kernel's name in reports; source: file in csrc/; replaces:
    the TPU kernel it ports (file:line function); entries: C function name
    -> ctypes argtypes (each returns the cudaError_t of its launches)."""

    name: str
    source: str
    replaces: str
    entries: dict
    launches: int = 0
    # Launches by mode, for the kernels that have modes (the compositors'
    # "t_in" and "tile0"); a launch in a mode counts in `launches` too.
    mode_launches: dict = dataclasses.field(default_factory=dict)
    build_log: str = ""
    _lib: ctypes.CDLL | None = dataclasses.field(default=None, repr=False)

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in [CSRC / self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start nvcc for this kernel unless its library exists. Returns
        (process, temp path, final path) or None."""
        out = self.library_path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _finish_build(self, started) -> None:
        proc, tmp, out = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        self.build_log = log

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            started = self._start_build()
            if started is not None:
                self._finish_build(started)
            path = self.library_path()
            if not self.build_log and path.with_suffix(".log").exists():
                self.build_log = path.with_suffix(".log").read_text()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in self.entries.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.sg_error_string.argtypes = [ctypes.c_int]
            lib.sg_error_string.restype = ctypes.c_char_p
            lib.sg_capture_begin.argtypes = [ctypes.c_void_p]
            lib.sg_capture_end.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
            self._lib = lib
        return self._lib

    def launch(self, entry: str, *args, modes=()) -> None:
        """Call a C entry point; raise if its launches reported an error.
        `modes` names the kernel's modes this launch runs in."""
        lib = self.lib()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = lib.sg_error_string(rc).decode()
            raise KernelLaunchError(f"{self.name}: {entry} failed with CUDA "
                                    f"error {rc} ({msg})")
        self.launches += 1
        for m in modes:
            self.mode_launches[m] = self.mode_launches.get(m, 0) + 1

    def reset_launches(self) -> None:
        self.launches = 0
        self.mode_launches.clear()


KERNELS: list[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def build_all(kernels=None) -> None:
    """Build every kernel's library, one nvcc per source, all started
    together; raises with the output of every build that failed."""
    kernels = list(KERNELS if kernels is None else kernels)
    started = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, s in started:
        if s is None:
            continue
        try:
            k._finish_build(s)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n\n".join(errors))
    for k in kernels:
        k.lib()


def captured_launches(kernel: Kernel, fn) -> int:
    """The kernels, memsets and copies one call of `fn` enqueues, counted
    without running them: `fn` is called once on a stream of its own (so
    that what it keeps per stream and the allocator's blocks exist), then
    once more while that stream is captured into a CUDA graph, whose nodes
    are counted and thrown away. `kernel` lends its library's two capture
    entry points. What `fn` returns from the captured call was never
    computed."""
    lib = kernel.lib()
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        fn()
        side.synchronize()
        handle = ctypes.c_void_p(side.cuda_stream)
        rc = lib.sg_capture_begin(handle)
        if rc != 0:
            raise KernelLaunchError(
                f"stream capture did not start: CUDA error {rc} "
                f"({lib.sg_error_string(rc).decode()})")
        nodes = ctypes.c_longlong(-1)
        try:
            fn()
        finally:
            rc = lib.sg_capture_end(handle, ctypes.byref(nodes))
        if rc != 0:
            raise KernelLaunchError(
                f"stream capture failed: CUDA error {rc} "
                f"({lib.sg_error_string(rc).decode()})")
    return nodes.value


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every tensor lies on
    one CUDA device; raises for any other placement."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, ndim: int | None = None) -> None:
    """Validate a kernel operand before its pointer is passed to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
