"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, ``_build/<name>-<hash>.so``, where
``<hash>`` is taken from the source, so an edited source is rebuilt and an
unchanged one is loaded as it is. The library is bound with ``ctypes``:
every pointer and the stream pass as ``c_void_p``. Nothing is built when a
module is imported; the first launch of a kernel builds its library, and
``build_all`` builds every source at once, one ``nvcc`` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo']

_libs = {}  # name -> loaded ctypes.CDLL (one per process, like dlopen)


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ([os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home
                 else []) + [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def sources():
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu'))


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is built, keyed by its hash
    (the source, its headers and the flags)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == name + '.cu' or f.endswith('.cuh'):
            with open(os.path.join(CSRC, f), 'rb') as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')


def _start(name):
    """Start nvcc for ``name`` unless its library is built; returns
    (process, tmp path, final path) or None."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, name + '.cu')]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name, job):
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file


def build_all():
    """Compile every source that is not built yet, all at once. Returns the
    seconds it took."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in sources()}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _libs[name] = ctypes.CDLL(library_path(name))
    return _libs[name]


def check(err, what):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
