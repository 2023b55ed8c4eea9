"""Build the native image core (``image_core.cpp``, g++ -> .so).

The library goes into the package's git-ignored ``_build/`` directory,
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is (the counterpart of
``semivl_tpu/native/build.py``, which builds beside the source, keyed by
mtime). Nothing is built when the module is imported.
"""

import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, 'image_core.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']
LIBS = ['-ljpeg', '-lpng']


def library_path():
    h = hashlib.sha256(' '.join(FLAGS + LIBS).encode())
    with open(SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f'image_core-{h.hexdigest()[:16]}.so')


def build():
    """The library's path, built first if it is not there (raises
    ``subprocess.CalledProcessError`` when g++ or a library is missing)."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib}.{os.getpid()}.tmp'
    subprocess.run(['g++', *FLAGS, SRC, '-o', tmp, *LIBS], check=True,
                   capture_output=True)
    os.replace(tmp, lib)
    return lib


if __name__ == '__main__':
    print(build())
