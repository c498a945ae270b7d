"""Builds and loads the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library
under ``build/megastep_tpu_torch/`` beside the package, and loaded with ``ctypes``.
The library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.

``python3 chip_smoke.py`` triggers the build; nothing here runs at import.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from . import tracing

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD = Path(__file__).resolve().parent.parent / 'build' / 'megastep_tpu_torch'

#: Flags every kernel is built with. No ``--use_fast_math``: divisions and square
#: roots stay correctly rounded. ``-fmad=false`` forbids FMA contraction, so that
#: the observe kernel computes the same f32 operations as its plain torch version,
#: op for op: a fused multiply-add can move a tolerance-edge raycast winner by
#: one ulp. That is a parity choice that a later performance change may revisit.
#: ``-Xptxas=-v`` puts registers, shared memory and spills in the build log.
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v', '-fmad=false')

_LIBS = {}


def nvcc():
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get('CUDA_HOME')
    for cand in ((Path(home) / 'bin' / 'nvcc') if home else None,
                 shutil.which('nvcc'), Path('/usr/local/cuda/bin/nvcc')):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on the PATH')


def library_path(name):
    """Where the shared library of kernel ``name`` is (or will be) built."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() + ' '.join(FLAGS).encode())
    return BUILD / f'{name}-{digest.hexdigest()[:16]}.so'


def build(name):
    """Compiles kernel ``name`` unless it is built already. Raises with the
    compiler's output if ``nvcc`` fails. The library is written under a
    temporary name and renamed, so a concurrent process never loads half a file.

    :return: the compiler's log, or None if the library was already built.
    """
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    with tracing.span('kernels.build'):
        proc = subprocess.run([nvcc(), *FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu:\n{proc.stdout}')
    os.replace(tmp, out)
    return proc.stdout


def load(name):
    """The loaded ``ctypes`` library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
