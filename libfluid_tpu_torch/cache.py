"""Where the built kernel libraries are kept across runs (the port's
counterpart of ``libfluid_tpu.cache``, which keeps XLA's compilation
cache).

:mod:`libfluid_tpu_torch._build` and :mod:`libfluid_tpu_torch.native`
compile their sources at first use into this directory, under a file name
that holds a hash of the sources' contents and the compiler's flags (as
XLA's cache is keyed by content), so a later run of the same sources skips
the compile and a run of other sources never loads this one's library. The
directory is ``$LIBFLUID_CACHE_DIR`` where that variable is set (the
variable the JAX package's cache honours), else ``libfluid_tpu_torch/build``
in the checkout.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Iterable

DEFAULT_DIR = Path(__file__).resolve().parent / "build"


def kernel_dir() -> Path:
    """The directory of the built kernel libraries."""
    return Path(os.environ.get("LIBFLUID_CACHE_DIR") or DEFAULT_DIR)


def keyed_path(name: str, files: Iterable[Path], flags: Iterable[str]) -> Path:
    """``<kernel_dir>/<stem>.<hash><suffix>`` for the library `name` built
    from `files` with `flags`: the hash covers each file's name and bytes
    and every flag, in order."""
    h = hashlib.sha256()
    for f in files:
        f = Path(f)
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    for flag in flags:
        h.update(str(flag).encode() + b"\0")
    stem, suffix = os.path.splitext(name)
    return kernel_dir() / f"{stem}.{h.hexdigest()[:16]}{suffix}"
