"""paddle.dataset.common (port of paddle_tpu/dataset/common.py; reference
dataset/common.py: DATA_HOME, md5file, download, cluster_files split
helpers)."""
from __future__ import annotations

import hashlib
import os

DATA_HOME = os.path.expanduser("~/.cache/paddle/dataset")

__all__ = ["DATA_HOME", "md5file", "download", "split",
           "cluster_files_reader"]


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """reference common.py download: the file for `url` under
    DATA_HOME/module_name. Nothing is fetched: a file already placed at
    the target path (with the right md5 when one is given) is used as
    it is, otherwise the error says what to place where."""
    dirname = os.path.join(DATA_HOME, module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(
        dirname, save_name or url.split("/")[-1])
    if os.path.exists(filename) and (
            not md5sum or md5file(filename) == md5sum):
        return filename
    raise RuntimeError(
        f"no network egress in this environment: place the file from "
        f"{url} at {filename} (md5 {md5sum}) to use this dataset")


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    import pickle
    dumper = dumper or pickle.dump
    lines, index = [], 0
    out = []
    for e in reader():
        lines.append(e)
        if len(lines) >= line_count:
            fn = suffix % index
            with open(fn, "wb") as f:
                dumper(lines, f)
            out.append(fn)
            lines, index = [], index + 1
    if lines:
        fn = suffix % index
        with open(fn, "wb") as f:
            dumper(lines, f)
        out.append(fn)
    return out


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    import glob
    import pickle
    loader = loader or pickle.load

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fn in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    yield from loader(f)
    return reader
