"""Append-only ``.npr`` record streams.

A copy of :mod:`megastep_tpu.rebar.numpy`, writing the same bytes for the same
rows: a standard npy v3 header declaring shape ``(0,)``, padded so the rows
start 64-byte aligned, then raw structured rows appended over time, with the
true length deduced from the file size at read time. The header is written
lazily from the first row's dtypes. One file per (channel, process), so
concurrent writers never contend.
"""
import ast
from collections import defaultdict

import numpy as np

from . import paths

MAGIC = b'\x93NUMPY'
VERSION = (3, 0)  # v3: utf8 header, 4-byte length field
ALIGN = 64


def rowtype(exemplar):
    """Structured dtype matching a flat dict of scalars."""
    dtype = np.dtype([(k, v.dtype if isinstance(v, np.generic) else type(v))
                      for k, v in exemplar.items()])
    if dtype.hasobject:
        raise TypeError("Arrays with objects get pickled, so can't be appended to")
    return dtype


def header_bytes(dtype):
    """The npy v3 header for an appendable stream: shape (0,) — readers recover
    the row count from the file size instead."""
    meta = ("{'descr': %r, 'fortran_order': False, 'shape': (0,), }"
            % (dtype.descr,)).encode('utf8')
    # Pad with spaces so data starts ALIGN-aligned; newline-terminated per spec.
    preamble = len(MAGIC) + 2 + 4
    pad = -(preamble + len(meta) + 1) % ALIGN
    meta += b' ' * pad + b'\n'
    return MAGIC + bytes(VERSION) + len(meta).to_bytes(4, 'little') + meta


def stream_dtype(stream):
    """Reads the npy header off an open stream, leaving it at the first row."""
    if stream.read(len(MAGIC)) != MAGIC:
        raise ValueError('not an npy/npr stream')
    major = stream.read(2)[0]
    length_field = 4 if major >= 2 else 2
    hlen = int.from_bytes(stream.read(length_field), 'little')
    meta = ast.literal_eval(stream.read(hlen).decode('utf8'))
    if meta['fortran_order']:
        raise ValueError('a Fortran-ordered stream cannot be appended to')
    return np.dtype(meta['descr'])


def pack(d, dtype):
    """One structured row, as bytes."""
    row = np.zeros((), dtype)
    for name in dtype.names:
        row[name] = d[name]
    return row.tobytes()


class FileWriter:
    """Appends dict-rows to one ``.npr`` file; the header is written lazily from
    the first row's dtypes, and every row is flushed so readers can tail live."""

    def __init__(self, path):
        self._path = path
        self._file = None
        self._dtype = None

    def write(self, d):
        if self._dtype is None:
            self._dtype = rowtype(d)
            self._file = self._path.open('wb', buffering=4096)
            self._file.write(header_bytes(self._dtype))
        if set(d) != set(self._dtype.names):
            raise ValueError(f'row fields {sorted(d)} differ from the stream\'s '
                             f'{sorted(self._dtype.names)}')
        self._file.write(pack(d, self._dtype))
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
        self._file = self._dtype = None


class FileReader:
    """Incrementally reads rows appended to one ``.npr`` file. Robust to tailing
    a live writer: a partially-flushed last row is left for the next call."""

    def __init__(self, path):
        self._path = path
        self._file = None
        self._dtype = None

    def read(self):
        """All complete rows appended since the last call."""
        if self._dtype is None:
            self._file = self._path.open('rb')
            self._dtype = stream_dtype(self._file)
        raw = self._file.read()
        frayed = len(raw) % self._dtype.itemsize
        if frayed:
            self._file.seek(-frayed, 1)
        return np.frombuffer(raw[:len(raw) - frayed], dtype=self._dtype)

    def close(self):
        if self._file is not None:
            self._file.close()
        self._file = self._dtype = None


class Writer:
    """Multi-channel writer: one FileWriter per channel under a run/group."""

    def __init__(self, run_name, group):
        self._run = paths.Run(run_name)
        self._group = group
        self._channels = {}

    def _writer(self, channel):
        if channel not in self._channels:
            p = self._run.file(self._group, channel).with_suffix('.npr')
            self._channels[channel] = FileWriter(p)
        return self._channels[channel]

    def write(self, channel, d):
        self._writer(channel).write(d)

    def write_many(self, ds):
        for channel, d in ds.items():
            self._writer(channel).write(d)

    def close(self):
        for w in self._channels.values():
            w.close()
        self._channels = {}


class Reader:
    """Multi-process reader: discovers all processes' files for a run/group and
    merges new rows per-channel."""

    def __init__(self, run_name, group):
        self._run = paths.Run(run_name)
        self._group = group
        self._tails = {}

    def _discover(self):
        for p in self._run.group(self._group).glob('**/*.npr'):
            info = paths.parse(p)
            key = (info.channel, info.filename)
            if key not in self._tails:
                self._tails[key] = FileReader(p)

    def read(self):
        """{channel: [new row arrays]} appended since the last call, across every
        writing process."""
        self._discover()
        fresh = defaultdict(list)
        for (channel, _), tail in self._tails.items():
            rows = tail.read()
            if len(rows):
                fresh[channel].append(rows)
        return fresh
