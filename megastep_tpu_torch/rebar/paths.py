"""Run-directory conventions.

A copy of :mod:`megastep_tpu.rebar.paths`: every run owns
``<ROOT>/<run>/<group>/<channel>/<procname>-<pid>`` files, and each process
writes only its own files, which makes the telemetry multi-process-safe by
construction. :class:`Run` is the handle; the module-level functions are thin
conveniences over it. ``ROOT`` is read at each call, so a caller (a test, a
smoke run) may point it elsewhere.
"""
import multiprocessing as mp
import os
import shutil
from pathlib import Path
from typing import NamedTuple

from ..dotdict import dotdict

ROOT = 'output/traces'

_FORBIDDEN = ('_', os.sep)


class TracePath(NamedTuple):
    """A parsed ``<run>/<group>/<channel...>/<procname>-<pid>`` trace path."""
    run_name: str
    group: str
    channel: str
    filename: str
    procname: str
    pid: str


class Run:
    """Handle on one run's trace directory."""

    def __init__(self, name):
        self.name = resolve(name)

    @property
    def dir(self):
        return Path(ROOT) / self.name

    def group(self, group, channel=''):
        """The directory for a group (optionally one channel of it)."""
        d = self.dir / group
        return d / channel if channel else d

    def file(self, group, channel=''):
        """This process's own file in group/channel, parents created. The run and
        group names must survive :func:`parse`, so no '_' or separators."""
        for name in (self.name, group):
            bad = [c for c in _FORBIDDEN if c in name]
            if bad:
                raise ValueError(f'Can\'t have "{bad[0]}" in the file path')
        me = mp.current_process()
        target = self.group(group, channel) / f'{me.name}-{me.pid}'
        target.parent.mkdir(exist_ok=True, parents=True)
        return target

    def files(self, group, channel='', pattern='*'):
        """Every process's files in group/channel, oldest-modified first."""
        found = self.group(group, channel).glob(pattern)
        return sorted(found, key=lambda p: p.stat().st_mtime)

    def clear(self, group=None):
        shutil.rmtree(self.group(group) if group else self.dir,
                      ignore_errors=True)

    def size(self, group):
        """Total size of a group's files, in MB."""
        return sum(f.stat().st_size
                   for f in self.group(group).glob('**/*.*')) / 1e6


def resolve(run_name):
    """A string names a run directly; an int indexes runs by creation time
    (-1 = latest)."""
    if isinstance(run_name, str):
        return run_name
    if isinstance(run_name, int):
        by_age = sorted(Path(ROOT).iterdir(), key=lambda p: p.stat().st_ctime)
        return by_age[run_name].name
    raise ValueError(f"Can't find a run corresponding to {run_name}")


def parse(p):
    """Splits a trace path back into run/group/channel/procname/pid (as a dotdict,
    for ``**``-formatting into display strings)."""
    run_name, group, *channel, filename = Path(p).relative_to(ROOT).with_suffix('').parts
    procname, _, pid = filename.rpartition('-')
    return dotdict(TracePath(run_name, group, '/'.join(channel), filename,
                             procname, pid)._asdict())


def runs():
    """All runs with creation times, oldest first, as a pandas frame."""
    import pandas as pd
    frame = pd.DataFrame(
        {'path': p,
         'created': pd.Timestamp(p.stat().st_ctime, unit='s'),
         'run_name': p.name}
        for p in Path(ROOT).iterdir())
    return frame.sort_values('created').reset_index(drop=True)


# Function-style conveniences (the reference's API shape).

def run_dir(run_name):
    return Run(run_name).dir


def subdirectory(run_name, group, channel=''):
    return Run(run_name).group(group, channel)


def path(run_name, group, channel=''):
    return Run(run_name).file(group, channel)


def glob(run_name, group, channel='', pattern='*'):
    return Run(run_name).files(group, channel, pattern)


def clear(run_name, group=None):
    Run(run_name).clear(group)


def size(run_name, group):
    return Run(run_name).size(group)
