"""Time one per-image feature file's write and read on this machine's file
system, for each way of making the calls.

``CocoData``'s first load reads one ``<id>.npy`` per image (123,287 in the
Karpathy split) and ``data/synthetic.write_synthetic_coco`` writes them.
Where every file-system call is slow, the number of calls per file sets the
time: this script writes and reads N files of 2048 f32 (an MSCOCO feature
row) under logs/file_calls/ (removed at the end) with np.save / np.load,
with one ``open()`` + ``write``/``read`` (what the port does), with
``os.open`` + ``os.write``/``os.read``, from 4 and 8 threads, and with
np.fromfile, and prints microseconds per file, then one JSON line.

    python3 scripts/torch_file_calls.py [N]          # default N = 20000
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv: list) -> int:
    n = int(argv[0]) if argv else 20000
    root = os.path.join("logs", "file_calls")
    os.makedirs(root, exist_ok=True)
    rows = np.random.default_rng(0).random((n, 2048), dtype=np.float32)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(rows[0]))
    head = buf.getvalue()
    size = len(head) + rows[0].nbytes
    paths = {k: [os.path.join(root, f"{k}{i}.npy") for i in range(n)]
             for k in "abcd"}
    out = {}

    def timed(name, fn, items, threads=0):
        t0 = time.perf_counter()
        if threads:
            with ThreadPoolExecutor(threads) as pool:
                got = list(pool.map(fn, items))
        else:
            got = [fn(x) for x in items]
        out[name] = 1e6 * (time.perf_counter() - t0) / len(items)
        print(f"{name}: {out[name]:.1f} us per file", flush=True)
        return got

    def write_open(i):
        with open(paths["b"][i], "wb") as f:
            f.write(head + rows[i].tobytes())

    def write_os(i, key="c"):
        fd = os.open(paths[key][i], os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                     0o644)
        try:
            os.write(fd, head + rows[i].tobytes())
        finally:
            os.close(fd)

    def read_open(path):
        with open(path, "rb") as f:
            return f.read()

    def read_os(path):
        fd = os.open(path, os.O_RDONLY)
        try:
            return os.read(fd, size + 1)
        finally:
            os.close(fd)

    try:
        timed("np.save", lambda i: np.save(paths["a"][i], rows[i]), range(n))
        timed("open + write", write_open, range(n))
        timed("os.open + os.write", write_os, range(n))
        timed("os.open + os.write, 4 threads",
              lambda i: write_os(i, "d"), range(n), threads=4)
        want = timed("np.load", lambda p: np.load(p), paths["a"])
        got = [timed("open + read", read_open, paths["b"]),
               timed("os.open + os.read", read_os, paths["c"]),
               timed("os.open + os.read, 4 threads", read_os, paths["d"],
                     threads=4),
               timed("os.open + os.read, 8 threads", read_os, paths["b"],
                     threads=8)]
        timed("np.fromfile", lambda p: np.fromfile(
            p, np.float32, offset=len(head)), paths["c"])
        same = all(np.array_equal(np.frombuffer(raw, np.float32,
                                                offset=len(head)), w)
                   for g in got for raw, w in zip(g, want))
        print(f"every read equals np.load's: {same}")
    finally:
        shutil.rmtree(root)
    print(json.dumps({"files": n, "us_per_file": out, "equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
